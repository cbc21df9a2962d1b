"""The card's kernel time per megapixel: the union of the kernel intervals in
the profiler's device trace of the window (copies and sets, which run on
the copy engines, left out), over the megapixels whose device work the
window ran. The SM time a model that shares the card loses to the decode."""

from jpegbench import layers


def read(run):
    return layers.device_ms_per_mp(run, kernels_only=True)
