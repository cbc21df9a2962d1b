"""The harness finds every configuration, cell and metric by name, and
finds new ones added as files alone; nothing it runs imports JAX or the
JAX package, and the reference imports nothing of the port either."""

import ast
import json
import os

import pytest

from jpegbench import harness as H


BENCH = H.load_benchmark()


def test_every_name_resolves_to_its_files():
    for c in BENCH["configs"]:
        cfg = H.load_json(H.ROOT, c["file"])
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("jpegbench/")
    for w in BENCH["workloads"]:
        run = H.Run(BENCH, w["name"], seed=1, device="cpu")
        assert run.config["name"] == w["config"]
        assert hasattr(run.loop, "warm") and hasattr(run.loop, "window")
        assert run.cell["chips"] == 1
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert callable(H.reader(m["name"]).read), m["name"]
            for cell in m.get("workloads", []):
                H.entry(BENCH["workloads"], cell, "workload")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer(cell):
    e2e = {m["name"] for m in H.metrics_for(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = H.metrics_for(BENCH, cell, "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)


def test_every_end_to_end_metric_has_a_bound_the_contract_allows():
    for m in BENCH["end_to_end"]:
        assert isinstance(m["bound"], float) and 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace"), m


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    from jpegbench.tests.tiny import tiny_root

    root = tiny_root(tmp_path)
    here = os.path.join(root, "jpegbench")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _d, fs in os.walk(here) for p in fs}
    # New files only: a traffic mix, a metric reader, and entries.
    with open(os.path.join(here, "traffic", "stream_nhwc.json"), "w") as f:
        json.dump({"loop": "stream_loop", "encoding": {"progressive": False, "restarts": True},
                   "chunk_size": 2, "depth": 1, "prep_workers": 1, "layout": "nhwc",
                   "warm_chunks": 1, "check_sample": 2}, f)
    with open(os.path.join(here, "metrics", "chunks_seen.stream.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.records)) or None\n")
    bench = H.load_benchmark(root)
    bench["workloads"].append({"name": "stream_nhwc_test", "config": "corpus_2048", "traffic": "stream_nhwc",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "chunks_seen.stream", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "stream", "moves": "setup_s",
                               "workloads": ["stream_nhwc_test"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    run = H.Run(H.load_benchmark(root), "stream_nhwc_test", seed=5, device="cpu", root=root)
    assert run.traffic["layout"] == "nhwc"
    assert [m["name"] for m in H.metrics_for(run.bench, "stream_nhwc_test", "per_layer")] == ["chunks_seen.stream"]
    run.records = [{}, {}]
    assert run.read("per_layer") == {"chunks_seen.stream": {"value": 2.0, "unit": "count"}}
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _d, fs in os.walk(here) for p in fs if p in before}
    assert after == before


def _snapshot(root):
    return {os.path.relpath(os.path.join(dp, p), root): open(os.path.join(dp, p), "rb").read()
            for dp, _d, fs in os.walk(root) for p in fs if "__pycache__" not in dp}


def test_a_mixed_size_cell_added_as_files_runs_correct(tmp_path, monkeypatch, capsys):
    from collections import Counter

    import tpujpeg_torch.kernels.wavefront as wf
    from jpegbench import run as R
    from jpegbench.reference import bitstream
    from jpegbench.tests.tiny import add_mixed_cell, tiny_root

    root = tiny_root(tmp_path)
    before = _snapshot(root)
    bench_before = json.loads(before.pop("BENCHMARK.json"))
    cell = add_mixed_cell(root)
    bench = H.load_benchmark(root)
    after = _snapshot(root)
    assert {p: after.get(p) for p in before} == before
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(bench_before[key])] == bench_before[key]
    # The batch ladder's per-image skeleton rung, spied on where it is called.
    skeleton = []
    real = wf.decode_norst_to_rgb
    monkeypatch.setattr(wf, "decode_norst_to_rgb",
                        lambda jpeg, *a, **k: skeleton.append(jpeg.frame.width) or real(jpeg, *a, **k))
    seed = 3000000019
    rc = R.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", "0"],
                device="cpu", require_cuda=False, root=root)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    # The pool, read back with the reference parser: every class in its count,
    # and a marker-free scan over the fused planner's cap.
    run = H.Run(bench, cell, seed=seed, device="cpu", root=root)
    pool = H.CachedPool(run.pool_path()).get()
    parsed = [bitstream.parse(it.data) for it in pool]
    assert Counter((j.frame.width, j.frame.height) for j in parsed) == Counter(
        {(c["width"], c["height"]): c["count"] for c in run.config["images"]})
    assert [it.mp for it in pool] == [j.frame.width * j.frame.height / 1e6 for j in parsed]
    words = [len(j.scans[0].data) // 4 + 2 for j in parsed]
    assert all(len(j.scans[0].rst_offsets) == 0 for j in parsed)
    assert max(words) > wf.MAX_WORDS > min(words)
    assert {j.frame.width for j, n in zip(parsed, words) if n > wf.MAX_WORDS} <= set(skeleton)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}


def _sources(sub=""):
    base = os.path.join(H.HERE, sub)
    return [os.path.join(dp, f) for dp, _d, fs in os.walk(base) for f in fs
            if f.endswith(".py") and "tests" not in dp.split(os.sep)]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & set(H.BANNED), path
    assert H.PORT.split(".")[0] not in H.BANNED


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert not _imports(path) & (set(H.BANNED) | {"tpujpeg_torch"}), path


def test_banned_names_compare_whole_top_level_names():
    assert H.banned_modules(["tpujpeg_torch", "tpujpeg_torch.kernels", "numpy"]) == []
    assert H.banned_modules(["tpujpeg.kernels", "jaxlib.xla", "jax_fake"]) == ["jaxlib", "tpujpeg"]
