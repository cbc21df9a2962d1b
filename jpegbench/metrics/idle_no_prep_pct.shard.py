"""stream: the share of the card's idle time in the steady slice during which no prep thread was inside parse or plan, in percent: idle that host prep does not explain."""

from jpegbench import spans


def read(run):
    return spans.idle_no_prep_pct(run)
