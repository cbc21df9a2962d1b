"""The mixed-size stream cell's readers on synthetic traces, logs and
orders: kernel A's launches paired with each chunk's geometry buckets in
order of first appearance (roofline_pct.kernel_a.shard), the prep
threads' plan spans per yielded fused chunk (buckets_per_chunk.shard),
and None wherever a run has nothing for them; and a tiny run of
stream_shard_420 on the CPU that reads every metric of the cell that a
run on the CPU can read."""

import json
import types

import pytest

from jpegbench import corpus, roofline
from jpegbench import spans as S
from jpegbench.reference import bitstream
from jpegbench.tests.test_jpegbench_spans import PREP1, _ev, _read, _rec, _run, _stream_run, _trace, _upload_run
from jpegbench.trace import STEADY, WINDOW, Trace

CELL = "stream_shard_420"
ROOFLINE, BUCKETS = "roofline_pct.kernel_a.shard", "buckets_per_chunk.shard"
KERNEL = "wavefront_pixels_kernel"

# Pool images 0 and 2 share a geometry; image 1 is larger.
POOL = [corpus.make_jpeg(w, h, seed=s, quality=85, subsampling=2, restart_blocks=4)
        for s, (w, h) in enumerate([(32, 24), (64, 48), (32, 24)])]


def _bound_ms(indices):
    work = [roofline.kernel_a_work(bitstream.parse(POOL[i])) for i in indices]
    return roofline.bound(sum(b for b, _o in work), sum(o for _b, o in work))[0]


def _kernel_run(durations_us, loop="stream_loop"):
    evs = [_ev(WINDOW, 0.0, 10000.0), _ev(STEADY, 0.0, 10000.0)]
    t = 100.0
    for d in durations_us:
        evs.append(_ev(KERNEL, t, t + d, device=True))
        t += d + 50.0
    trace = Trace(types.SimpleNamespace(events=lambda: evs))
    pool = [types.SimpleNamespace(data=d, mp=0.001) for d in POOL]
    # Chunks of 3: [1, 0, 1] buckets as {1, 1}, {0}; [0, 2, 1] as {0, 2}, {1}.
    return types.SimpleNamespace(trace=trace, traffic={"loop": loop, "chunk_size": 3}, pool=pool,
                                 order=[1, 0, 1, 0, 2, 1], records=[{"engine": "wavefront-fused"}] * 2)


def test_launches_pair_with_buckets_in_order_of_first_appearance():
    buckets = [[1, 1], [0], [0, 2], [1]]
    bounds = [_bound_ms(b) for b in buckets]
    assert bounds[0] != bounds[1]
    durations = [40.0, 10.0, 25.0, 30.0]
    got = _read(ROOFLINE, _kernel_run(durations))
    assert got == pytest.approx(100.0 * sum(bounds) * 1e3 / sum(durations))
    # One launch: the chunk's first bucket is that of its first member.
    assert _read(ROOFLINE, _kernel_run([40.0])) == pytest.approx(100.0 * bounds[0] * 1e3 / 40.0)
    # More launches than the order's whole chunks: the sums stop at the buckets.
    more = durations + [99.0, 99.0]
    assert _read(ROOFLINE, _kernel_run(more)) == pytest.approx(got)


def _plan_run(engines):
    """Prep-thread plan spans: 4 in chunk 0, 3 in chunk 1, 4 in chunk 2
    (prepped ahead, not yielded); a plan on the window's thread in chunk 1
    (the fallback's ladder plans there)."""
    recs = [_rec(S.PLAN, u, at + k, at + k, thread=PREP1)
            for u, at, n in ((0, 1500.0, 4), (1, 7100.0, 3), (2, 8100.0, 4)) for k in range(n)]
    recs.append(_rec(S.PLAN, 1, 7000.0, 7050.0))
    return _run("stream_loop", recs, _trace([], device=[]), [{"engine": e} for e in engines])


def test_buckets_per_chunk_counts_the_prep_plans_of_the_yielded_fused_chunks():
    assert _read(BUCKETS, _plan_run(["wavefront-fused"] * 2)) == pytest.approx((4 + 3) / 2)
    assert _read(BUCKETS, _plan_run(["wavefront-fused", "fallback"])) == pytest.approx(4)
    assert _read(BUCKETS, _plan_run(["fallback", "fallback"])) is None   # the parent's fallback


def test_nothing_to_read_gives_none():
    untraced = _stream_run()
    untraced.trace = None
    assert _read(BUCKETS, untraced) is None and _read(ROOFLINE, untraced) is None
    assert _read(ROOFLINE, _kernel_run([])) is None                        # no kernel A launch
    assert _read(ROOFLINE, _kernel_run([40.0], loop="upload_loop")) is None  # not a stream
    assert _read(BUCKETS, _upload_run([])) is None
    for name in ("idle_no_prep_pct.shard", "card_wait_pct.shard", "launches_per_chunk.shard",
                 "prep_ms_per_mp.shard"):
        assert _read(name, untraced) is None, name
    for name in ("plan_ms_per_mp.shard", "parse_ms_per_mp.shard", "chunk_gap_p95_ms.shard"):
        assert _read(name, _upload_run([])) is None, name


def test_a_tiny_run_of_the_cell_is_correct_and_stays_fused(tmp_path, capsys):
    from jpegbench import run as R
    from jpegbench.tests.tiny import tiny_root

    rc = R.main(["--workload", CELL, "--seed", "3000000019", "--seconds", "1", "--trace", "1"],
                device="cpu", require_cuda=False, root=tiny_root(tmp_path))
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    assert metrics["fallback_share.shard"]["value"] == 0.0
    # The host layers timed alone; the CPU run takes no trace.
    assert metrics["plan_ms_per_mp.shard"]["value"] > 0 and metrics["parse_ms_per_mp.shard"]["value"] > 0
