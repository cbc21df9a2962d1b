"""The host's side of a run at a tiny size on the CPU: the pool's cache,
the megapixels a stream keeps in flight, and the per-layer readers that
time the host's layers."""

import pytest

from jpegbench import harness as H
from jpegbench import run as R
from jpegbench.tests.tiny import tiny_root

ARGS = ["--seed", "3000000023", "--seconds", "1", "--trace", "0"]


def test_the_pool_is_made_once_per_seed_and_read_back_equal(tmp_path):
    root = tiny_root(tmp_path)
    bench = H.load_benchmark(root)
    made = []
    for seed in (11, 11, 12):
        run = H.Run(bench, "uploads_4k_rst", seed=seed, device="cpu", root=root)
        with H.Workers(2) as w:
            pending = run.start_pool(w)
            pool = [(it.data, it.mp, it.sampling) for it in pending.get()]
        made.append((type(pending).__name__, pending.path, pool))
    assert [m[0] for m in made] == ["NewPool", "CachedPool", "NewPool"]
    assert made[0][1:] == made[1][1:]
    assert made[2][1] != made[0][1] and made[2][2] != made[0][2]


@pytest.mark.parametrize("cell", ["stream_2048_420", "uploads_4k_rst"])
def test_host_layers_are_read_and_device_work_counts_what_is_in_flight(tmp_path, cell):
    args = R.parse_args(["--workload", cell] + ARGS)
    run = R.setup(args, "cpu", False, tiny_root(tmp_path))
    run.window(args.seconds)
    assert run.mp_done > 0
    if cell.startswith("stream") and run.records[-1]["engine"] != "fallback":
        depth, cs = run.traffic["depth"], run.traffic["chunk_size"]
        k = len(run.records)
        extra = sum(run.pool[i].mp for i in run.order[k * cs:(k + depth - 1) * cs])
        assert extra > 0 and run.mp_device == pytest.approx(run.mp_done + extra)
    else:
        assert run.mp_device == pytest.approx(run.mp_done)
    layer = run.read("per_layer")
    side = "stream" if cell.startswith("stream") else "upload"
    want = {f"parse_ms_per_mp.{side}", f"plan_ms_per_mp.{side}"}
    want |= ({"chunk_gap_p95_ms.stream", "fallback_share.stream"} if side == "stream"
             else {"service_ms_p50.upload"})
    assert set(layer) == want
    assert all(v["value"] >= 0 for v in layer.values())
    assert all(layer[k]["value"] > 0 for k in want if not k.startswith("fallback"))
