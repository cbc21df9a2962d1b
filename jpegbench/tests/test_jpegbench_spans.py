"""The readers of the port's spans and counters (jpegbench/spans.py and
the eight metrics that use it) on a synthetic log and trace: shares of
the steady slice, the chunk-id selection, the clock offset between the
log and the trace, the prep threads against the card's idle time, and
None wherever a run has nothing for a reader."""

import collections
import types

import pytest
from torch.autograd import DeviceType

from jpegbench import harness as H
from jpegbench import spans as S
from jpegbench.trace import STEADY, WINDOW, Trace

Rec = collections.namedtuple("Rec", "name unit id parent thread start_ns end_ns n mirrored")

EPOCH_NS = 1_760_000_000_123_456_789   # the trace's start on the epoch clock
MAIN, PREP1, PREP2 = 11, 22, 33        # thread ids in the log
STREAM_METRICS = ["prep_wait_pct.stream", "card_wait_pct.stream", "prep_ms_per_mp.stream",
                  "idle_no_prep_pct.stream", "ladder_plan_pct.stream", "launches_per_chunk.stream"]
UPLOAD_METRICS = ["plan_pct.upload", "copy_in_pct.upload"]


def _ev(name, start_us, end_us, device=False, thread=1):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start_us, end=end_us),
                                 thread=thread, is_user_annotation=False,
                                 device_type=DeviceType.CUDA if device else DeviceType.CPU)


def _trace(host, device, steady=(1000.0, 9000.0)):
    evs = [_ev(WINDOW, 0.0, 10000.0), _ev(STEADY, *steady)] + [_ev(n, s, e) for n, s, e in host]
    evs += [_ev("kernel", s, e, device=True) for s, e in device]
    return Trace(types.SimpleNamespace(events=lambda: evs))


def _rec(name, unit, start_us, end_us, thread=MAIN, n=0, jitter_ns=0):
    """A log record at trace time [start_us, end_us], on the epoch clock."""
    t0 = EPOCH_NS + int(start_us * 1000) + jitter_ns
    t1 = EPOCH_NS + int(end_us * 1000) + jitter_ns
    counter = name == S.LAUNCH
    return Rec(name, unit, None if counter else 1, None, thread, t0, t1, n, thread == MAIN and not counter)


def _run(loop, recs, trace, records, order=(), chunk_size=2):
    drained = []

    def drain():
        drained.append(1)
        return list(recs)

    port = types.SimpleNamespace(spans=types.SimpleNamespace(drain=drain))
    pool = [types.SimpleNamespace(mp=0.5 * (i + 1)) for i in range(8)]
    return types.SimpleNamespace(port=port, trace=trace, traffic={"loop": loop, "chunk_size": chunk_size},
                                 records=records, order=list(order), pool=pool, drained=drained)


def _read(name, run):
    return H.reader(name).read(run)


def _stream_run():
    host = [(S.PREP_WAIT, 1000.0, 2000.0), (S.CARD_WAIT, 2000.0, 2500.0), (S.PREP_WAIT, 5000.0, 5500.0),
            (S.PREP_WAIT, 500.0, 800.0)]   # the last before the steady slice
    trace = _trace(host, device=[(2000.0, 2400.0), (6000.0, 6500.0)])
    recs = [
        # The window thread's spans, also in the trace; the log's clock runs
        # a few microseconds off the profiler's, by turns.
        _rec(S.PREP_WAIT, 0, 1000.0, 2000.0, jitter_ns=3000),
        _rec(S.CARD_WAIT, 0, 2000.0, 2500.0, jitter_ns=-2000),
        _rec(S.PREP_WAIT, 1, 5000.0, 5500.0, jitter_ns=1000),
        _rec(S.PREP_WAIT, 2, 500.0, 800.0),
        # The prep threads: chunks 0 and 1 yielded, chunk 2 prepped ahead.
        _rec(S.PARSE, 0, 1000.0, 2000.0, thread=PREP1),
        _rec(S.PLAN, 0, 2000.0, 3000.0, thread=PREP1),
        _rec(S.PARSE, 1, 7000.0, 7200.0, thread=PREP2),
        _rec(S.PLAN, 1, 7200.0, 7500.0, thread=PREP2),
        _rec(S.PARSE, 2, 8000.0, 8600.0, thread=PREP1),
        _rec(S.LAUNCH, 0, 2100.0, 2100.0, n=1), _rec(S.LAUNCH, 0, 2101.0, 2101.0, n=1),
        _rec(S.LAUNCH, 1, 5600.0, 5600.0, n=2), _rec(S.LAUNCH, 2, 9500.0, 9500.0, n=2),
    ]
    chunks = [{"engine": "wavefront-fused"}, {"engine": "wavefront-fused"}]
    return _run("stream_loop", recs, trace, chunks, order=[3, 1, 0, 2, 7, 6])


def test_the_clock_offset_is_the_median_over_the_spans_in_both():
    run = _stream_run()
    assert S.offset_ns(run) == EPOCH_NS + 1000


def test_stream_shares_of_the_steady_slice():
    run = _stream_run()
    assert _read("prep_wait_pct.stream", run) == pytest.approx(100.0 * 1500 / 8000)
    assert _read("card_wait_pct.stream", run) == pytest.approx(100.0 * 500 / 8000)
    assert _read("ladder_plan_pct.stream", run) is None   # no plan on the window's thread
    assert run.drained == [1]   # drained once, kept for every reader


def test_prep_and_launches_count_only_the_yielded_chunks():
    run = _stream_run()
    mp = 2.0 + 1.0 + 0.5 + 1.5   # pool images 3, 1, 0, 2: chunks 0 and 1
    assert _read("prep_ms_per_mp.stream", run) == pytest.approx((1.0 + 1.0 + 0.2 + 0.3) / mp)
    assert _read("launches_per_chunk.stream", run) == pytest.approx(2.0)


def test_idle_no_prep_is_the_idle_no_prep_thread_covers():
    run = _stream_run()
    # Idle in [1000, 9000]: all but [2000, 2400] and [6000, 6500], 7100 us.
    # Prep threads cover [1000, 3000] and [7000, 7500] (chunk 2's [8000,
    # 8600] too: any prep explains idle); idle covered 1000 + 600 + 500 +
    # 600 = 2700 us, shifted 1 us by the offset's median.
    got = _read("idle_no_prep_pct.stream", run)
    assert got == pytest.approx(100.0 * (7100 - 2700) / 7100, abs=0.05)


def _upload_run(recs):
    trace = _trace([(S.DECODE, 100.0, 1100.0), (S.DECODE, 3000.0, 4000.0)], device=[(500.0, 600.0)],
                   steady=(0.0, 10000.0))
    return _run("upload_loop", recs, trace, [{"due": 0.0}, {"due": 0.0}])


def test_upload_shares_of_the_decode_spans():
    recs = [
        _rec(S.DECODE, 5, 100.0, 1100.0), _rec(S.DECODE, 6, 3000.0, 4000.0),
        _rec(S.PLAN, 5, 200.0, 400.0), _rec(S.PLAN, 6, 3100.0, 3400.0),
        _rec(S.COPY_IN, 5, 400.0, 500.0), _rec(S.COPY_IN, 6, 3400.0, 3450.0),
        # A request of no decode span in the window: left out.
        _rec(S.PLAN, 9, 20000.0, 29000.0),
    ]
    run = _upload_run(recs)
    assert _read("plan_pct.upload", run) == pytest.approx(100.0 * 500 / 2000)
    assert _read("copy_in_pct.upload", run) == pytest.approx(100.0 * 150 / 2000)
    for name in STREAM_METRICS:
        assert _read(name, run) is None, name


def test_nothing_to_read_gives_none():
    run = _stream_run()
    for name in UPLOAD_METRICS:
        assert _read(name, run) is None, name
    # A port without spans (the parent of the change that added them).
    bare = _stream_run()
    bare.port = types.SimpleNamespace()
    untraced = _stream_run()
    untraced.trace = None
    empty = _run("stream_loop", [], _trace([], device=[(2000.0, 2400.0)]), [])
    for r in (bare, untraced, empty):
        for name in STREAM_METRICS + UPLOAD_METRICS:
            assert _read(name, r) is None, name
    assert untraced.drained == []   # an untraced run leaves the log alone
