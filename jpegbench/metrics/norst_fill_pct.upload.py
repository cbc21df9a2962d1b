"""planner: the lanes of the marker-free plans split for the card, over the lanes one wave of kernel A holds there (the port's norst_lanes and norst_wave counters), summed over the window's decode() spans, in percent."""

from jpegbench import layers, spans

LANES, WAVE = "norst_lanes", "norst_wave"


def read(run):
    recs = spans.log(run)
    off = spans.offset_ns(run) if recs and not layers.is_stream(run) else None
    if off is None:
        return None
    lo, hi = run.trace.window
    units = {r.unit for r in recs if r.name == spans.DECODE and lo <= (r.start_ns - off) * 1e-3 <= hi}
    lanes = sum(r.n for r in recs if r.name == LANES and r.unit in units)
    wave = sum(r.n for r in recs if r.name == WAVE and r.unit in units)
    return 100.0 * lanes / wave if wave else None
