"""stream: the port's launch counts in the chunks yielded in the window, per chunk: kernel A and one color kernel for each geometry bucket of a fused chunk."""

from jpegbench import spans


def read(run):
    return spans.launches_per_chunk(run)
