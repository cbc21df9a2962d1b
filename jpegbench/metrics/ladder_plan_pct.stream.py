"""batch ladder: the share of the steady slice the window thread spent in the port's plan spans (the fallback's plan_scans, DC-refine masks included), in percent."""

from jpegbench import spans


def read(run):
    return spans.main_pct(run, spans.PLAN)
