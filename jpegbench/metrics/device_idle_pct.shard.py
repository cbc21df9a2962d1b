"""device: 1 - (union of kernel, copy and set intervals) / the steady slice of the traced window of a mixed-size stream (from the first chunk yielded), in percent."""

from jpegbench import layers


def read(run):
    return layers.idle_pct(run) if layers.mp_per_s(run) is not None else None
