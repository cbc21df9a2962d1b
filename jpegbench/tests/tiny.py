"""A copy of the benchmark at a size the CPU runs in seconds: the cells'
configurations cut to a few 64x48 images, the traffic to small chunks."""

import json
import os
import shutil

from jpegbench import harness as H


def tiny_root(tmp_path, rates=None) -> str:
    root = str(tmp_path / "checkout")
    shutil.copytree(H.HERE, os.path.join(root, "jpegbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = H.load_benchmark()
    for c in bench["configs"]:
        cfg = H.load_json(H.ROOT, c["file"])
        cfg.update(width=64, height=48, pool=4)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in {w["traffic"] for w in bench["workloads"]}:
        path = H.traffic_file(name, os.path.join(root, "jpegbench"))
        with open(path) as f:
            t = json.load(f)
        t.update(check_sample=3)
        if t["loop"] == "stream_loop":
            t.update(chunk_size=2, warm_chunks=1)
        else:
            t.update(rate_per_s=(rates or {}).get(name, 4.0), warm_rounds=1)
        with open(path, "w") as f:
            json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
