"""device: the share of the steady slice the window thread spent blocked on the card (the port's tpujpeg_torch.card_wait spans), in percent."""

from jpegbench import spans


def read(run):
    return spans.main_pct(run, spans.CARD_WAIT)
