"""Device stages of the port: each module holds a kernel's wrapper and its
plain torch version (wavefront: kernel A; sample_color: kernels B-D),
plus the pipeline glue and the nvcc/ctypes build."""
