"""device: the port's copy_in spans (plans copied to the card) inside the window's decode() spans, over their time, in percent."""

from jpegbench import spans


def read(run):
    return spans.decode_pct(run, spans.COPY_IN)
