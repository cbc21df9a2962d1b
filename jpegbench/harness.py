"""The benchmark's machinery: it finds a cell's configuration, traffic mix,
loop and metric readers by name, makes the cell's pool of JPEGs from the
seed, drives the port through the loop, reads the metrics and judges what
the timed path produced against the plain reference.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own:

- ``BENCHMARK.json`` (the checkout's root) names the cells and metrics;
- ``configs/<config>.json``: the images of a deployment (size, quality,
  sampling, restart interval, pool), one size or a mix of classes;
- ``traffic/<traffic>.json``: a mix's parameters, with ``loop`` naming
  the module ``traffic/<loop>.py`` that drives it (``warm(run)`` and
  ``window(run, seconds)``);
- ``metrics/<metric>.py``: ``read(run)``, the metric's value or None where
  the run has nothing for it to read.

Nothing here imports torch or the port at module level: worker processes
import this module to make the pool and to run the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import importlib.util
import json
import multiprocessing
import os
import pickle
import random
import resource
import sys
import time
from typing import Dict, List, Optional

import numpy as np


HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "tpujpeg_torch"
# Top-level module names no process of the benchmark may hold: JAX and the
# JAX package the port was made from (compared whole, so the port's name,
# which begins with the JAX package's, does not match).
BANNED = ("jax", "jaxlib", "flax", "tpujpeg")
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}  # PIL's codes
WORKERS = 8


def banned_modules(modules=None) -> List[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(BANNED))


def cache_env(root: str = ROOT) -> None:
    """Point every build and kernel cache a library may use at fixed
    directories inside the checkout (the port builds its kernels into
    ``tpujpeg_torch/_build`` itself)."""
    base = os.path.join(root, ".jpegbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")
    os.environ.setdefault("USE_FLAX", "0")


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def traffic_file(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", f"{name}.json")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(kind: str, here: str = HERE):
    return load_module(os.path.join(here, "traffic", f"{kind}.py"), f"jpegbench.traffic.{kind}")


def reader(metric: str, here: str = HERE):
    return load_module(os.path.join(here, "metrics", f"{metric}.py"),
                       "jpegbench.metrics." + metric.replace(".", "_"))


def metrics_for(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list the cell, or list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------------------
# The pool of JPEGs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Item:
    data: bytes
    mp: float
    sampling: str


def image_cycle(config: dict) -> List[tuple]:
    """The (width, height) the pool's images take in turn: the
    configuration's one ``width``/``height``, or its ``images``, a list of
    classes ``{"width", "height", "count"}`` each listed ``count`` times in
    the file's order. Every class takes the configuration's ``quality``."""
    if ("images" in config) == ("width" in config or "height" in config):
        raise ValueError(f"configuration {config.get('name')!r}: give either width and height, or images")
    if "images" not in config:
        return [(config["width"], config["height"])]
    cycle = []
    for c in config["images"]:
        if set(c) != {"width", "height", "count"}:
            raise ValueError(f"configuration {config.get('name')!r}: a class has width, height and count alone")
        if not (isinstance(c["count"], int) and c["count"] >= 1):
            raise ValueError(f"configuration {config.get('name')!r}: a class's count must be a whole number >= 1")
        cycle += [(c["width"], c["height"])] * c["count"]
    if not cycle:
        raise ValueError(f"configuration {config.get('name')!r}: images lists no class")
    return cycle


def pool_specs(config: dict, traffic: dict, seed: int) -> List[dict]:
    """The pool's images: sizes by turns over the configuration's cycle
    (``image_cycle``), and each size's sampling by turns over the list in
    the order that size comes, so that every seed makes the same mix and
    every size meets every sampling; pixels from (seed, index)."""
    enc = traffic["encoding"]
    cycle = image_cycle(config)
    seen = collections.Counter()
    out = []
    for i in range(config["pool"]):
        w, h = cycle[i % len(cycle)]
        sampling = config["sampling"][seen[w, h] % len(config["sampling"])]
        seen[w, h] += 1
        image_seed = int(np.random.SeedSequence([seed % 2**63, i]).generate_state(1, np.uint64)[0])
        out.append(dict(w=w, h=h, seed=image_seed, quality=config["quality"],
                        sampling=sampling, progressive=bool(enc.get("progressive")),
                        restart_blocks=config["restart_mcus"] if enc.get("restarts") else 0,
                        kind=config.get("image_kind", "photo")))
    return out


def pool_path(specs: List[dict], root: str = ROOT) -> str:
    """The cache file of a pool: keyed by every image's parameters (the
    configuration, the traffic's encoding, the seed) and by the
    generator's source, so that a change to either makes a new pool."""
    h = hashlib.sha256(json.dumps(specs, sort_keys=True).encode())
    with open(os.path.join(HERE, "corpus.py"), "rb") as f:
        h.update(f.read())
    return os.path.join(root, ".jpegbench_cache", "pool", h.hexdigest()[:32] + ".pkl")


class CachedPool:
    """A pool read back from its cache file."""

    def __init__(self, path: str):
        self.path = path

    def get(self) -> List[Item]:
        with open(self.path, "rb") as f:
            return [Item(*t) for t in pickle.load(f)]


class NewPool:
    """A pool being made by the workers; written to its cache file once made."""

    def __init__(self, pending, path: str):
        self.pending, self.path = pending, path

    def get(self) -> List[Item]:
        items = self.pending.get()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".part"
        with open(tmp, "wb") as f:
            pickle.dump([(it.data, it.mp, it.sampling) for it in items], f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.path)
        return items


def make_item(spec: dict) -> Item:
    from . import corpus

    data = corpus.make_jpeg(spec["w"], spec["h"], seed=spec["seed"], quality=spec["quality"],
                            subsampling=SUBSAMPLING[spec["sampling"]], progressive=spec["progressive"],
                            restart_blocks=spec["restart_blocks"], kind=spec["kind"])
    return Item(data, spec["w"] * spec["h"] / 1e6, spec["sampling"])


class Workers:
    """Spawned worker processes (none for n = 0), closed and joined on exit."""

    def __init__(self, n: int):
        self.pool = multiprocessing.get_context("spawn").Pool(n) if n > 0 else None

    def __enter__(self):
        return self

    def terminate(self) -> None:
        if self.pool is not None:
            self.pool.terminate()

    def __exit__(self, *exc):
        if self.pool is None:
            return
        if exc[0] is None:
            self.pool.close()
        else:
            self.pool.terminate()
        self.pool.join()


# ---------------------------------------------------------------------------
# What the window produced, and the judgement of it
# ---------------------------------------------------------------------------


class Sample:
    """A uniform sample of k of the window's outputs (reservoir sampling
    with a generator seeded from the run's seed). An output kept is cloned:
    the program may reuse its buffer."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"sample:{seed}")
        self.seen = 0
        self.kept: List[tuple] = []   # (pool index, image, layout)

    def offer(self, index: int, image, layout: str) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, image.clone(), layout))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = (index, image.clone(), layout)


def as_hwc(image, layout: str):
    """uint8 [H, W, 3] of an output in the layout its producer reported:
    "nhwc", or "packed16" (planar uint16 [3, H, W/2] whose little-endian
    bytes are the planar uint8 raster)."""
    import torch

    if layout == "packed16":
        return image.contiguous().view(torch.uint8).permute(1, 2, 0)
    if layout != "nhwc":
        raise ValueError(f"unknown layout {layout!r}")
    return image


def reference_coefficients(datas: Dict[int, bytes], workers: int) -> Dict[int, list]:
    from .reference import decode as ref

    keys = sorted(datas)
    with Workers(max(1, min(workers, len(keys)))) as w:
        res = w.pool.map(ref.coefficients, [datas[k] for k in keys], chunksize=1)
    return dict(zip(keys, res))


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def process_start() -> float:
    """This process's start on the epoch clock (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def cpu_seconds() -> float:
    """User and system CPU time of every thread of this process."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


class Run:
    """One cell's run: what the loops and the metric readers share."""

    def __init__(self, bench: dict, cell: str, seed: int, device: str = "cuda", root: str = ROOT):
        self.bench = bench
        self.root = root
        self.here = os.path.join(root, "jpegbench")   # where the data files and readers are
        self.cell = entry(bench["workloads"], cell, "workload")
        cfg_entry = entry(bench["configs"], self.cell["config"], "config")
        self.config = load_json(root, cfg_entry["file"])
        with open(traffic_file(self.cell["traffic"], self.here)) as f:
            self.traffic = json.load(f)
        self.loop = loop_module(self.traffic["loop"], self.here)
        self.seed = seed
        self.device = device
        self.port = None
        self.torch = None
        self.pool: List[Item] = []
        self.trace = None
        self.reset()

    def reset(self) -> None:
        """Forget the last window's records."""
        self.records: List[dict] = []   # what the loop logs per chunk or request
        self.attempted = 0
        self.failed = 0
        self.mp_done = 0.0
        self.t0 = self.t1 = 0.0
        self.start_epoch = 0.0          # the first timed request, on the epoch clock
        self.cpu_s = 0.0
        self.mp_device = 0.0            # MP whose device work the window ran
        self.order: List[int] = []       # pool index of each image the loop offered
        self.sample = Sample(int(self.traffic["check_sample"]), self.seed)
        self.trace = None
        self.trace_on = False
        self.kernel_s: Optional[float] = None  # the card's kernel time in the window
        self.device_s: Optional[float] = None  # the card's kernel, copy and set time in it
        self.error: Optional[str] = None  # the last failed request's exception

    # -- set-up ------------------------------------------------------------

    def pool_path(self) -> str:
        return pool_path(pool_specs(self.config, self.traffic, self.seed), self.root)

    def start_pool(self, workers: Workers):
        """The pool from its cache file inside the checkout, or made by the
        workers and then cached."""
        specs = pool_specs(self.config, self.traffic, self.seed)
        path = pool_path(specs, self.root)
        if os.path.exists(path):
            return CachedPool(path)
        return NewPool(workers.pool.map_async(make_item, specs, chunksize=1), path)

    def import_port(self):
        import torch

        self.torch = torch
        self.port = importlib.import_module(PORT)
        return self.port

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, trace: bool = False) -> None:
        """The loop's window under ``torch.profiler``: the card's activity
        alone (for ``kernel_s``), or with ``trace`` the host's too (for the
        per-layer metrics). On the CPU nothing is profiled."""
        self.reset()
        self.trace_on = trace
        if not self.device.startswith("cuda"):
            self.loop.window(self, seconds)
            return
        from torch.profiler import ProfilerActivity, profile

        from .trace import Trace, device_seconds

        acts = ([ProfilerActivity.CPU] if trace else []) + [ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            self.loop.window(self, seconds)
            self.sync()
        if trace:
            self.trace = Trace(prof)
            self.kernel_s, self.device_s = self.trace.kernel_s(), self.trace.device_s()
        else:
            self.kernel_s, self.device_s = device_seconds(prof)

    def begin(self) -> None:
        """The loop's first timed request starts now."""
        self.start_epoch = time.time()
        self.t0 = time.perf_counter()
        self.cpu0 = cpu_seconds()

    def end(self) -> None:
        self.t1 = time.perf_counter()
        self.cpu_s = cpu_seconds() - self.cpu0
        self.mp_device += self.mp_done

    def offer(self, index: int, image, layout: str) -> None:
        self.sample.offer(index, image, layout)

    # -- metrics -------------------------------------------------------------

    def read(self, kind: str) -> Dict[str, dict]:
        out = {}
        for m in metrics_for(self.bench, self.cell["name"], kind):
            value = reader(m["name"], self.here).read(self)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    # -- correctness -----------------------------------------------------------

    def judge(self, control: Optional[str] = None, workers: int = WORKERS) -> Dict[str, dict]:
        """Every kept output against the plain reference's decode of the
        same bytes. With `control` (an IDCT of the reference: "float"), the
        reference computed so stands in the program's place: the reading
        a control must fail."""
        torch = self.torch
        kept = self.sample.kept
        coeffs = reference_coefficients({i: self.pool[i].data for i, _im, _l in kept}, workers)
        mismatched = 0
        refs: Dict[int, object] = {}
        from .reference import decode as ref

        for i, image, layout in kept:
            if i not in refs:
                refs[i] = ref.rgb(self.pool[i].data, coeffs[i], self.device)
            want = refs[i]
            got = (ref.rgb(self.pool[i].data, coeffs[i], self.device, idct=control) if control
                   else as_hwc(image, layout))
            if tuple(got.shape) != tuple(want.shape) or got.dtype != torch.uint8:
                mismatched += want.numel()
            else:
                mismatched += int((got != want).sum())
        return {
            "mismatched_bytes": {"value": mismatched, "limit": 0},
            "failed": {"value": self.failed, "limit": 0},
            "checked": {"value": len(kept), "limit": 1},
        }


def correct(checks: Dict[str, dict]) -> bool:
    return (checks["mismatched_bytes"]["value"] <= checks["mismatched_bytes"]["limit"]
            and checks["failed"]["value"] <= checks["failed"]["limit"]
            and checks["checked"]["value"] >= checks["checked"]["limit"])


def check_lines(checks: Dict[str, dict]) -> List[str]:
    rel = {"checked": ">="}
    return [f"check {k} {v['value']} limit {rel.get(k, '<=')} {v['limit']}" for k, v in checks.items()]
