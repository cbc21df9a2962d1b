"""The port's spans and counters (tpujpeg_torch.spans) on device="cpu":
off without a profiler, one unit per stream chunk on the main thread and
the prep threads, one plan span per geometry bucket of a fused chunk, the
progressive fallback's ladder, decode()'s nesting, and the log's clock
against the profiler's.

The images are 16x16 (corpus.make_jpeg): the kernels' plain versions take
about a second for each 48x48 image on the CPU, and a profile of them
several times that, while the file is held to a few seconds. The card's
side (a profile of the card alone records nothing, the launch counts of a
fused chunk) is in tests/test_torch_cuda.py."""

import collections
import threading

import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from corpus import make_jpeg

import tpujpeg_torch
from tpujpeg_torch import bitstream, spans
from tpujpeg_torch.kernels import build
from tpujpeg_torch.kernels import wavefront_prog as wp

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def empty_log():
    spans.drain()
    yield
    spans.drain()


def _fused(n=2):
    return [make_jpeg(16, 16, seed=s, subsampling=2, quality=85, restart_blocks=8) for s in range(n)]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans.drain(), prof


def test_off_without_a_profiler_records_nothing():
    assert not spans.recording()
    assert spans.span(spans.PARSE) is spans.span(spans.PLAN)
    assert spans.adopt(None) is spans.span(spans.PARSE)
    spans.count(spans.LAUNCH)
    chunks = list(tpujpeg_torch.decode_stream(_fused(), chunk_size=1, **CPU))
    assert len(chunks) == 2 and all(c.engine == "wavefront-fused" for c in chunks)
    assert spans.drain() == []


def test_traced_fused_stream_gives_each_chunk_a_unit_on_both_sides():
    main = threading.get_ident()
    chunks, recs, _prof = _traced(lambda: list(tpujpeg_torch.decode_stream(
        _fused(), chunk_size=1, depth=2, prep_workers=2, **CPU)))
    assert [c.members for c in chunks] == [[0], [1]]
    on_main = collections.Counter((r.name, r.unit) for r in recs if r.thread == main)
    for name in (spans.PREP_WAIT, spans.SUBMIT, spans.SYNC, spans.CARD_WAIT):
        assert on_main[(name, 0)] >= 1 and on_main[(name, 1)] >= 1, name
    # The main thread's spans are profile events too; counters (its
    # a_buckets count per kernel-A launch) never are.
    assert all(r.mirrored for r in recs if r.thread == main and r.id is not None)
    assert {r.name for r in recs if r.thread == main and r.id is None} == {spans.A_BUCKETS}
    prep = [r for r in recs if r.thread != main]
    assert prep and not any(r.mirrored for r in prep)
    assert {(r.name, r.unit) for r in prep} == {(n, u) for n in (spans.PARSE, spans.PLAN) for u in (0, 1)}
    # The copies into the device happen inside the submit of their chunk.
    submits = {r.id: r.unit for r in recs if r.name == spans.SUBMIT}
    copies = [r for r in recs if r.name == spans.COPY_IN]
    assert copies and all(submits[r.parent] == r.unit for r in copies)
    assert all(r.start_ns <= r.end_ns for r in recs)


def test_traced_mixed_stream_plans_each_bucket_once_in_its_chunks_unit():
    """A fused chunk of mixed geometry records one ``plan`` span per
    geometry bucket, on its prep thread, in its own unit; untraced,
    nothing."""
    a, b = _fused(1)[0], make_jpeg(32, 16, seed=4, subsampling=2, quality=85, restart_blocks=8)
    datas = [a, b, a, a, b]
    main = threading.get_ident()
    chunks, recs, _prof = _traced(lambda: list(tpujpeg_torch.decode_stream(datas, chunk_size=2, **CPU)))
    assert [c.engine for c in chunks] == ["wavefront-fused"] * 3
    plans = [r for r in recs if r.name == spans.PLAN]
    assert collections.Counter(r.unit for r in plans) == {0: 2, 1: 1, 2: 1}
    assert all(r.thread != main and not r.mirrored for r in plans)
    list(tpujpeg_torch.decode_stream(datas, chunk_size=2, **CPU))
    assert spans.drain() == []


def test_traced_progressive_chunk_runs_the_ladder_under_its_chunk(monkeypatch):
    # The plain versions stand in for kernels 7-9 here: count each as the
    # launch its kernel makes on the card.
    for name in ("dc_first_plain", "ac_first_plain", "ac_refine_plain"):
        plain = getattr(wp, name)
        kernel = "prog_" + name[: -len("_plain")]

        def counted(*args, _plain=plain, _kernel=kernel):
            build.launched(_kernel)
            return _plain(*args)

        monkeypatch.setattr(wp, name, counted)
    datas = _fused(1) + [make_jpeg(16, 16, seed=5, subsampling=2, progressive=True)]
    before = sum(build.LAUNCHES.values())
    chunks, recs, _prof = _traced(lambda: list(tpujpeg_torch.decode_stream(datas, chunk_size=1, **CPU)))
    assert [c.engine for c in chunks] == ["wavefront-fused", "fallback"]
    mine = [r for r in recs if r.unit == 1]
    by_name = collections.defaultdict(list)
    for r in mine:
        by_name[r.name].append(r)
    (fallback,) = by_name[spans.FALLBACK]
    (ladder,) = by_name[spans.LADDER]
    assert ladder.parent == fallback.id
    assert any(r.thread == fallback.thread and r.mirrored for r in by_name[spans.PLAN])
    kernel_scans = sum(wp.scan_kind(s) != "dc_refine" for s in bitstream.parse(datas[1]).scans)
    launches = by_name[spans.LAUNCH]
    assert sum(r.n for r in launches) == kernel_scans == sum(build.LAUNCHES.values()) - before
    assert all(r.id is None and r.start_ns == r.end_ns for r in launches)
    assert not any(r.name in (spans.FALLBACK, spans.LADDER, spans.LAUNCH) for r in recs if r.unit == 0)


def test_decode_nests_its_layers_under_one_decode_record():
    data = _fused(1)[0]
    _out, recs, _prof = _traced(lambda: tpujpeg_torch.decode(data, **CPU))
    (dec,) = [r for r in recs if r.name == spans.DECODE]
    names = {r.name for r in recs if r.parent == dec.id}
    assert {spans.PARSE, spans.PLAN, spans.CARD_WAIT} <= names
    assert all(r.unit == dec.unit for r in recs)
    assert all(dec.start_ns <= r.start_ns <= r.end_ns <= dec.end_ns for r in recs)
    _out, again, _prof = _traced(lambda: tpujpeg_torch.decode(data, **CPU))
    assert {r.unit for r in again} == {dec.unit + 1}


def test_log_times_land_on_the_profilers_clock():
    data = _fused(1)[0]
    _jpeg, recs, prof = _traced(lambda: bitstream.parse(data))
    (rec,) = recs
    assert rec.name == spans.PARSE and rec.mirrored
    (ev,) = [e for e in prof.events() if e.name == spans.PARSE and e.device_type == DeviceType.CPU]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    assert abs(t0 + ev.time_range.start * 1e3 - rec.start_ns) < 1e6
    assert abs(t0 + ev.time_range.end * 1e3 - rec.end_ns) < 1e6


def test_adopt_carries_a_unit_to_a_thread_the_profiler_does_not_see():
    seen = []

    def worker(parent):
        with spans.adopt(7, parent):
            seen.append(spans.recording())
            with spans.span(spans.PLAN):
                spans.count(spans.LAUNCH, 3)
        seen.append(spans.recording())

    t = threading.Thread(target=worker, args=(41,))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [True, False]
    plan, launch = sorted(spans.drain(), key=lambda r: r.name != spans.PLAN)
    assert (plan.unit, plan.parent, plan.mirrored) == (7, 41, False)
    assert (launch.unit, launch.parent, launch.n) == (7, plan.id, 3)
    assert spans.drain() == []
