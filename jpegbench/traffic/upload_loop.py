"""Uploads decoded one at a time: an open loop of Poisson arrivals served
by one thread that calls ``decode(data, DecodeConfig(to_numpy=False))``
(which returns with the image synchronised on the card).

The traffic file gives ``rate_per_s``, ``warm_rounds`` and the
``sweep_rates`` that ``jpegbench.sweep`` runs. Every seed gets the same
arrivals and the same frames in another order: the gaps are the
exponential distribution's quantiles at (k + 0.5) / M for M = rate x
seconds requests, scaled to fill the window, then shuffled; the frames
take the configuration's samplings in equal shares (as near as M allows),
shuffled, each sampling cycling through its pool frames. A request is
timed from when it was due; one that finds the server idle waits for its
due time, and how late the server then starts it is the generator's
lateness.
"""

from __future__ import annotations

import time

import numpy as np

from ..trace import STEADY, WINDOW, span


def warm(run) -> None:
    cfg = run.port.DecodeConfig(to_numpy=False)
    for _ in range(run.traffic["warm_rounds"]):
        for item in run.pool:
            run.port.decode(item.data, cfg, device=run.device)
    run.sync()


def schedule(run, rate: float, seconds: float):
    """(due offsets in seconds, pool index) of each request."""
    rng = np.random.default_rng([run.seed % 2**63, 2])
    m = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    by_kind = {}
    for i, item in enumerate(run.pool):
        by_kind.setdefault(item.sampling, []).append(i)
    kinds = sorted(by_kind)
    seq = rng.permutation(np.array([kinds[k % len(kinds)] for k in range(m)], dtype=object))
    cursor = {k: 0 for k in kinds}
    cycles = {k: [] for k in kinds}
    index = []
    for kind in seq:
        if cursor[kind] == len(cycles[kind]):
            cycles[kind] = [by_kind[kind][j] for j in rng.permutation(len(by_kind[kind]))]
            cursor[kind] = 0
        index.append(cycles[kind][cursor[kind]])
        cursor[kind] += 1
    return due.tolist(), index


def window(run, seconds: float, rate: float = None) -> None:
    due, index = schedule(run, rate or run.traffic["rate_per_s"], seconds)
    cfg = run.port.DecodeConfig(to_numpy=False)
    tracing = run.trace_on
    run.order = index
    with span(WINDOW, tracing), span(STEADY, tracing):
        run.begin()
        for d, i in zip(due, index):
            t_due = run.t0 + d
            now = time.perf_counter()
            idle = now < t_due
            if idle:
                with span("jpegbench.idle", tracing):
                    time.sleep(t_due - now)
            start = time.perf_counter()
            ok = True
            try:
                with span("jpegbench.request", tracing):
                    image = run.port.decode(run.pool[i].data, cfg, device=run.device)
                    run.sync()
            except Exception as e:  # a failed request misses every limit
                ok = False
                run.error = repr(e)
            end = time.perf_counter()
            run.attempted += 1
            if ok:
                run.mp_done += run.pool[i].mp
                run.offer(i, image, "nhwc")
            else:
                run.failed += 1
            run.records.append(dict(due=t_due, start=start, end=end, ok=ok, index=i, idle=idle))
        run.end()
