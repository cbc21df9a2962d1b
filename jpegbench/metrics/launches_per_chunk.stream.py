"""batch ladder: the port's launch counts in the chunks yielded in the window, per chunk."""

from jpegbench import spans


def read(run):
    return spans.launches_per_chunk(run)
