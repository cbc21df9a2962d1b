"""kernels: kernel 9's device time (profiler) over its scans against the least time their counted bytes and operations need at the published peaks, in percent."""

from jpegbench import layers


def read(run):
    return layers.roofline_kernel_9(run)
