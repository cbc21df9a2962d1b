"""planner: the port's plan spans inside the window's decode() spans, over their time, in percent."""

from jpegbench import spans


def read(run):
    return spans.decode_pct(run, spans.PLAN)
