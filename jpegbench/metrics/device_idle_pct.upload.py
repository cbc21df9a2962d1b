"""device: 1 - (union of kernel, copy and set intervals) / the traced window, in percent."""

from jpegbench import layers


def read(run):
    return layers.idle_pct(run) if layers.latencies_ms(run) is not None else None
