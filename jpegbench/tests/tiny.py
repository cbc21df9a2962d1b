"""A copy of the benchmark at a size the CPU runs in seconds: the cells'
configurations cut to a few small images (one size to 64x48, a class list
to small distinct sizes), the traffic to small chunks."""

import json
import os
import shutil

from jpegbench import harness as H

# A class list's largest class: a marker-free scan over the fused planner's
# 512-word cap, so the batch ladder takes it alone. The other classes, in
# the file's order, from 40x30 up in steps of 8x6: partial MCUs, under it.
LARGE = (160, 120)
SMALL, STEP = (40, 30), (8, 6)


def tiny_config(cfg: dict) -> dict:
    """`cfg` cut to the CPU: one size to 64x48 in a pool of 4; a class
    list to small distinct sizes, each class in its count, in a pool of one
    cycle."""
    cfg = dict(cfg)
    if "images" not in cfg:
        cfg.update(width=64, height=48, pool=4)
        return cfg
    areas = [c["width"] * c["height"] for c in cfg["images"]]
    largest = areas.index(max(areas))
    classes = []
    for k, c in enumerate(cfg["images"]):
        j = k - (k > largest)
        w, h = LARGE if k == largest else (SMALL[0] + STEP[0] * j, SMALL[1] + STEP[1] * j)
        classes.append(dict(c, width=w, height=h))
    cfg.update(images=classes, pool=sum(c["count"] for c in classes))
    return cfg


def tiny_traffic(t: dict, rate: float = 4.0) -> dict:
    t = dict(t, check_sample=3)
    if t["loop"] == "stream_loop":
        t.update(chunk_size=2, warm_chunks=1)
    else:
        t.update(rate_per_s=rate, warm_rounds=1)
    return t


def tiny_root(tmp_path, rates=None) -> str:
    root = str(tmp_path / "checkout")
    shutil.copytree(H.HERE, os.path.join(root, "jpegbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = H.load_benchmark()
    for c in bench["configs"]:
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(tiny_config(H.load_json(H.ROOT, c["file"])), f)
    for name in {w["traffic"] for w in bench["workloads"]}:
        path = H.traffic_file(name, os.path.join(root, "jpegbench"))
        with open(path) as f:
            t = json.load(f)
        with open(path, "w") as f:
            json.dump(tiny_traffic(t, (rates or {}).get(name, 4.0)), f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


# A mixed-size configuration and a marker-free stream over it, as a later
# change would add them: new files and new entries only. Made up for the
# tests: the class list is benchmarks/imagenet_shard.py's 4:3:2:1 mix, but
# that shard codes a restart every 4 MCUs and this stream drops them, so
# that the largest class overruns the fused planner's cap.
MIXED_CELL = "stream_mixed_norst"
MIXED_CONFIG = {
    "name": "mixed_shard",
    "source": "made up for the tests; sizes after benchmarks/imagenet_shard.py:36-42",
    "images": [{"width": 512, "height": 512, "count": 4},
               {"width": 768, "height": 512, "count": 3},
               {"width": 1024, "height": 1024, "count": 2},
               {"width": 2048, "height": 2048, "count": 1}],
    "quality": 85,
    "sampling": ["4:2:0"],
    "restart_mcus": 4,
    "image_kind": "photo",
    "pool": 1024,
}
MIXED_TRAFFIC = {"loop": "stream_loop", "encoding": {"progressive": False, "restarts": False},
                 "chunk_size": 32, "depth": 2, "prep_workers": 2, "layout": "packed16",
                 "warm_chunks": 1, "check_sample": 24}


def add_mixed_cell(root: str) -> str:
    """Add, as new files in the tiny copy at `root`, a configuration with a
    class list, a marker-free stream over it whose warm-up walks the whole
    pool once, and their entries in ``BENCHMARK.json``; the cell's name."""
    here = os.path.join(root, "jpegbench")
    cfg = tiny_config(MIXED_CONFIG)
    traffic = tiny_traffic(MIXED_TRAFFIC)
    traffic["warm_chunks"] = -(-cfg["pool"] // traffic["chunk_size"])
    rel = f"jpegbench/configs/{cfg['name']}.json"
    for path, doc in ((os.path.join(root, rel), cfg), (H.traffic_file(MIXED_CELL, here), traffic)):
        assert not os.path.exists(path), path
        with open(path, "w") as f:
            json.dump(doc, f)
    bench = H.load_benchmark(root)
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": rel,
                             "reduced": ["pool"], "why": "test"})
    bench["workloads"].append({"name": MIXED_CELL, "config": cfg["name"], "traffic": MIXED_CELL,
                               "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return MIXED_CELL
