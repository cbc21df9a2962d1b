"""The port's own spans and counters, read after a traced window.

While a window runs under a profile of the host, the port
(``tpujpeg_torch.spans``) records a span at each layer boundary and a
``launch`` counter for each kernel launch, each with the unit it belongs
to: the stream's chunk index, or ``decode()``'s request number. The spans
of the window's thread are host events of the profile too (``Trace``
holds them, on the trace's clock); those of the stream's prep threads are
in the port's log alone, on the epoch clock. The readers here drain that
log once per run, keep it on the run, and place its times on the trace's
clock by the offset between the spans found in both.

Where the checkout's port has no span module (one from before it), or the
run was not traced, every reader returns None.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple

from . import layers
from .trace import _union

DECODE = "tpujpeg_torch.decode"
PREP_WAIT = "tpujpeg_torch.stream.prep_wait"
CARD_WAIT = "tpujpeg_torch.card_wait"
PARSE = "tpujpeg_torch.parse"
PLAN = "tpujpeg_torch.plan"
COPY_IN = "tpujpeg_torch.copy_in"
LAUNCH = "launch"
PREP = (PARSE, PLAN)


def log(run) -> Optional[list]:
    """The port's records of the window (``spans.drain()``, called once per
    trace and kept on the run), or None where the port has no span module
    or the run was not traced."""
    mod = getattr(run.port, "spans", None)
    if mod is None or run.trace is None:
        return None
    trace, recs = run.__dict__.get("_port_spans", (None, None))
    if trace is not run.trace:
        recs = mod.drain()
        run._port_spans = (run.trace, recs)
    return recs


def _dur_ns(r) -> int:
    return r.end_ns - r.start_ns


def offset_ns(run) -> Optional[int]:
    """Epoch time minus trace time, in ns: the (upper) median over the window
    thread's spans found both in the log (``mirrored``) and among the
    trace's host events, paired in order within each name whose counts
    agree."""
    recs = log(run)
    if not recs:
        return None
    logged = collections.defaultdict(list)
    for r in recs:
        if r.mirrored:
            logged[r.name].append(r.start_ns)
    traced = collections.defaultdict(list)
    for s, _e, name, _t in run.trace._main:
        if name in logged:
            traced[name].append(s)
    diffs = sorted(a - round(b * 1e3) for name, starts in logged.items() if len(traced[name]) == len(starts)
                   for a, b in zip(sorted(starts), sorted(traced[name])))
    return diffs[len(diffs) // 2] if diffs else None


def _overlap_us(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """The total length of the intersection of two sorted lists of
    disjoint intervals."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


# -- the stream -----------------------------------------------------------------


def yielded(run) -> int:
    """Chunks the stream yielded in the window: chunk k is the stream's
    k-th (``run.order[k * chunk_size:(k + 1) * chunk_size]``)."""
    return sum("engine" in r for r in run.records)


def main_pct(run, name: str) -> Optional[float]:
    """The share of the steady slice the window's thread spent in the
    port's span `name` (the union of its host events there), in percent."""
    if log(run) is None or not layers.is_stream(run):
        return None
    lo, hi = run.trace.slice
    inside = _union([(max(s, lo), min(e, hi)) for s, e, n, _t in run.trace._main
                     if n == name and e > lo and s < hi])
    if not inside or hi <= lo:
        return None
    return 100.0 * sum(e - s for s, e in inside) / (hi - lo)


def prep_ms_per_mp(run) -> Optional[float]:
    """The prep threads' ``parse`` and ``plan`` time for the chunks the
    window yielded, in ms per MP of those chunks."""
    recs, n = log(run), yielded(run)
    if not recs or not n:
        return None
    sel = [r for r in recs if not r.mirrored and r.name in PREP and r.unit is not None and r.unit < n]
    if not sel:
        return None
    cs = run.traffic["chunk_size"]
    mp = sum(run.pool[i].mp for i in run.order[: n * cs])
    return sum(_dur_ns(r) for r in sel) * 1e-6 / mp


def idle_no_prep_pct(run) -> Optional[float]:
    """The share of the card's idle time in the steady slice during which
    no prep thread was inside ``parse`` or ``plan``, in percent: idle time
    that host prep does not explain."""
    recs = log(run)
    off = offset_ns(run) if recs and layers.is_stream(run) else None
    if off is None:
        return None
    lo, hi = run.trace.slice
    idle, prev = [], lo
    for s, e in run.trace.busy() + [(hi, hi)]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    idle_us = sum(e - s for s, e in idle)
    if idle_us <= 0:
        return None
    prep = _union([((r.start_ns - off) * 1e-3, (r.end_ns - off) * 1e-3) for r in recs
                   if not r.mirrored and r.name in PREP])
    return 100.0 * (idle_us - _overlap_us(idle, prep)) / idle_us


def launches_per_chunk(run) -> Optional[float]:
    """Kernel launches counted in the chunks the window yielded, per chunk."""
    recs, n = log(run), yielded(run)
    if recs is None or not n:
        return None
    return sum(r.n for r in recs if r.name == LAUNCH and r.unit is not None and r.unit < n) / n


# -- the uploads ----------------------------------------------------------------


def decode_pct(run, name: str) -> Optional[float]:
    """The time of the port's span `name` inside the window's ``decode``
    spans (the same requests), over theirs, in percent."""
    recs = log(run)
    off = offset_ns(run) if recs and not layers.is_stream(run) else None
    if off is None:
        return None
    lo, hi = run.trace.window
    calls = [r for r in recs if r.name == DECODE and lo <= (r.start_ns - off) * 1e-3 <= hi]
    total = sum(_dur_ns(r) for r in calls)
    if total <= 0:
        return None
    units = {r.unit for r in calls}
    return 100.0 * sum(_dur_ns(r) for r in recs if r.name == name and r.unit in units) / total
