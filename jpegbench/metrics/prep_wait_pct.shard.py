"""stream: the share of the steady slice the window thread of a mixed-size stream spent in the port's tpujpeg_torch.stream.prep_wait span (waiting on a prep future), in percent."""

from jpegbench import spans


def read(run):
    return spans.main_pct(run, spans.PREP_WAIT)
