"""kernels: kernel A's device time (profiler) on the upload plans against the least time its counted bytes and operations need at the published peaks, in percent."""

from jpegbench import layers


def read(run):
    return layers.roofline_kernel_a(run) if layers.latencies_ms(run) is not None else None
