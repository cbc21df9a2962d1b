"""What the metric readers share: the arithmetic over a window's records
and counts, the host layers timed alone, and the roofline shares read
from the trace.

Layers, from the entry down: ``stream`` (``parallel/stream.py``) and
``decoder`` (``decoder.py``); ``batch ladder`` (``parallel/batch.py``);
``bitstream`` (parse); ``planner`` (``kernels/wavefront.py``,
``kernels/wavefront_prog.py`` and ``native/``); ``kernels``
(``csrc/*.cu``); ``device``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import roofline
from .reference import bitstream as ref_bitstream

# -- end to end -------------------------------------------------------------


def window_s(run) -> float:
    return run.t1 - run.t0


def mp_per_s(run) -> Optional[float]:
    if not run.records or "engine" not in run.records[0] or run.mp_done <= 0:
        return None
    return run.mp_done / window_s(run)


def cpu_ms_per_mp(run) -> Optional[float]:
    return run.cpu_s * 1e3 / run.mp_done if run.mp_done > 0 else None


def latencies_ms(run) -> Optional[np.ndarray]:
    """Each request's time from due to its image synchronised on the card;
    a failed request never arrives (NEVER ms, past every limit)."""
    if not run.records or "due" not in run.records[0]:
        return None
    return np.array([(r["end"] - r["due"]) * 1e3 if r["ok"] else NEVER for r in run.records])


NEVER = 1e12


def p95(values) -> float:
    return float(np.percentile(values, 95))


def device_ms_per_mp(run, kernels_only: bool = False) -> Optional[float]:
    """The card's busy time in the window (the union of its kernel, copy
    and set intervals, or of its kernels alone) per MP whose device work
    the window ran."""
    s = run.kernel_s if kernels_only else run.device_s
    return s * 1e3 / run.mp_device if s and run.mp_device > 0 else None


def chunk_gaps_ms(run) -> Optional[np.ndarray]:
    """The host's clock between consecutive yielded chunks."""
    t = [r["t"] for r in run.records if "engine" in r]
    return np.diff(t) * 1e3 if len(t) > 1 else None


def service_ms(run) -> Optional[np.ndarray]:
    """Each request's time inside ``decode()``, queueing left out."""
    if not run.records or "due" not in run.records[0]:
        return None
    return np.array([(r["end"] - r["start"]) * 1e3 for r in run.records if r["ok"]])


# -- host layers timed alone, after the window, on one thread ---------------------

STREAM_IMAGES = 32   # one chunk of the stream's pool
UPLOAD_IMAGES = 8    # frames of the upload pool, each sampling in turn


def _timed_ms(fn, reps: int) -> float:
    """The least of `reps` wall times of fn(), in ms: the least is the one
    that other work on the host disturbed least."""
    import time

    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def _port(run, name: str):
    import importlib

    return importlib.import_module(f"{run.port.__name__}.{name}")


def _layer_items(run) -> List[int]:
    n = STREAM_IMAGES if is_stream(run) else UPLOAD_IMAGES
    return list(range(min(n, len(run.pool))))


def is_stream(run) -> bool:
    return run.traffic["loop"] == "stream_loop"


def parse_ms_per_mp(run) -> Optional[float]:
    """bitstream: the port's parser over a fixed set of the pool's images."""
    if not run.records:
        return None
    bs = _port(run, "bitstream")
    items = _layer_items(run)
    ms = _timed_ms(lambda: [bs.parse(run.pool[i].data) for i in items], 3)
    return ms / sum(run.pool[i].mp for i in items)


def plan_ms_per_mp(run) -> Optional[float]:
    """planner: the planner the cell's path takes, over the same images:
    ``build_block_plan(pin_memory=True)`` on one stream chunk, the
    progressive ``plan_scans`` per scan group, ``build_block_plan`` on one
    upload frame at a time, or ``build_norst_plan``."""
    if not run.records:
        return None
    bs, wf, wp = _port(run, "bitstream"), _port(run, "kernels.wavefront"), _port(run, "kernels.wavefront_prog")
    items = _layer_items(run)
    jpegs = [bs.parse(run.pool[i].data) for i in items]
    enc = run.traffic["encoding"]
    if enc.get("progressive"):
        groups = {}
        for j in jpegs:
            groups.setdefault(wp.scan_group_key(j), []).append(j)
        fn, reps = (lambda: [wp.plan_scans(g) for g in groups.values()]), 2
    elif is_stream(run):
        fn, reps = (lambda: wf.build_block_plan(jpegs, pin_memory=run.device.startswith("cuda"))), 3
    elif enc.get("restarts"):
        fn, reps = (lambda: [wf.build_block_plan([j]) for j in jpegs]), 3
    else:
        fn, reps = (lambda: [wf.build_norst_plan(j) for j in jpegs]), 3
    return _timed_ms(fn, reps) / sum(run.pool[i].mp for i in items)


def fallback_share(run) -> Optional[float]:
    chunks = [r for r in run.records if "engine" in r]
    if not chunks:
        return None
    return 100.0 * sum(r["engine"] == "fallback" for r in chunks) / len(chunks)


def host(run) -> Dict[str, float]:
    """What the window's users feel on the host's clock: the stream's rate,
    the uploads' tail latency, and the CPU time per MP; and the card's busy
    time per MP with the copies in. Too noisy on a shared host for a bound
    (PERF.md §2); printed beside the metrics."""
    out: Dict[str, float] = {}
    copies = device_ms_per_mp(run)
    if copies is not None:
        out["device_ms_per_mp"] = copies
    rate = mp_per_s(run)
    if rate is not None:
        out["decode_mp_per_s"] = rate
    lat = latencies_ms(run)
    if lat is not None:
        out["latency_p95_ms"] = p95(lat)
    cpu = cpu_ms_per_mp(run)
    if cpu is not None:
        out["host_cpu_ms_per_mp"] = cpu
    return out


# -- the trace ------------------------------------------------------------------


def idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.slice_s() <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.slice_s())


def _share(durations: List[float], bounds_ms: List[float]) -> Optional[float]:
    n = min(len(durations), len(bounds_ms))
    if n == 0 or sum(durations[:n]) <= 0:
        return None
    return 100.0 * sum(bounds_ms[:n]) * 1e-3 / sum(durations[:n])


def _parsed(run, index: int):
    cache = run.__dict__.setdefault("_ref_parsed", {})
    if index not in cache:
        cache[index] = ref_bitstream.parse(run.pool[index].data)
    return cache[index]


def _work(run, key, fn):
    """fn()'s (bytes, operations), counted once per pool image and scan."""
    cache = run.__dict__.setdefault("_ref_work", {})
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def roofline_kernel_a(run) -> Optional[float]:
    """Kernel A's device time in the trace against the least time its
    work needs: each launch is one fused stream chunk, or one request."""
    if run.trace is None:
        return None
    durations = run.trace.kernels("wavefront_pixels_kernel")
    if not durations:
        return None
    if run.records and "engine" in run.records[0]:
        cs = run.traffic["chunk_size"]
        units = [run.order[c * cs:(c + 1) * cs] for c in range(len(durations))]
    else:
        units = [[r["index"]] for r in run.records[:len(durations)]]
    bounds = []
    for unit in units:
        work = [_work(run, ("a", i), lambda i=i: roofline.kernel_a_work(_parsed(run, i))) for i in unit]
        bounds.append(roofline.bound(sum(b for b, _o in work), sum(o for _b, o in work))[0])
    return _share(durations, bounds)


def roofline_kernel_9(run) -> Optional[float]:
    """Kernel 9's device time over its scans against the least time their
    work needs. The stream's chunks launch it once per AC refinement scan
    for each group of images that share a launch, in order: the launches
    are matched to whole chunks."""
    if run.trace is None or not run.records or "engine" not in run.records[0]:
        return None
    durations = run.trace.kernels("prog_ac_refine_kernel")
    if not durations:
        return None
    cs = run.traffic["chunk_size"]
    bounds: List[float] = []
    c = 0
    while len(bounds) < len(durations) and (c + 1) * cs <= len(run.order):
        groups = {}
        for i in run.order[c * cs:(c + 1) * cs]:
            key = _work(run, ("key", i), lambda i=i: roofline.group_key(_parsed(run, i)))
            groups.setdefault(key, []).append(i)
        for members in groups.values():
            scans = [k for k, s in enumerate(_parsed(run, members[0]).scans) if roofline.is_ac_refine(s)]
            for k in scans:
                work = [_work(run, ("9", i, k), lambda i=i, k=k: roofline.kernel_9_work(_parsed(run, i), k))
                        for i in members]
                bounds.append(roofline.bound(sum(b for b, _o in work), sum(o for _b, o in work))[0])
        c += 1
    return _share(durations, bounds)
