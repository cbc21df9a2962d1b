"""Run one cell of the benchmark once and print its result.

    python3 -m jpegbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``tpujpeg_torch``), on a machine with as many CUDA cards as the
cell asks for; without them it exits 2 and prints no result. The pool of
JPEGs is made from the seed (and cached inside the checkout, keyed by
its parameters); set-up (pool, kernel builds, warm-up) ends at the first
timed request. The window runs under ``torch.profiler``: ``--trace 0``
traces the card alone
and prints the cell's end-to-end metrics, ``--trace 1`` traces the host
too and prints its per-layer metrics, the device's busy time and a
breakdown. Beside them, under ``host``, every reading of the window the
driver does not read (the host's-clock rate, tail latency and CPU time
per MP among them). Every run judges a sample of what the window
produced against the plain reference after the window, prints the
numbers compared beside their limits as the last lines of standard
error, and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import harness as H
from . import layers


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m jpegbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup(args, device: str, require_cuda: bool, root: str) -> H.Run:
    """Make the pool, import the port, warm the cell's shapes. Raises
    SystemExit(2) where the cell's cards are missing."""
    bench = H.load_benchmark(root)
    run = H.Run(bench, args.workload, args.seed, device=device, root=root)
    run.process_start = H.process_start()
    H.cache_env(root)
    cached = os.path.exists(run.pool_path())
    with H.Workers(0 if cached else min(H.WORKERS, os.cpu_count() or 1)) as workers:
        pending = run.start_pool(workers)
        import torch

        chips = run.cell["chips"]
        if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
            workers.terminate()
            print(f"jpegbench: {args.workload} needs {chips} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            raise SystemExit(2)
        try:
            run.import_port()
        except ImportError as e:
            workers.terminate()
            print(f"jpegbench: the port is not importable from this checkout: {e}", file=sys.stderr)
            raise SystemExit(1)
        since = lambda: time.time() - run.process_start
        run.setup_phases = {"pool_cached": cached, "imports_done_s": since()}
        run.pool = pending.get()
        run.setup_phases["pool_done_s"] = since()
    run.loop.warm(run)
    run.setup_phases["warm_done_s"] = since()
    return run


def measure(run: H.Run, args) -> dict:
    """The window, its metrics, the device, then the judgement."""
    torch = run.torch
    cuda = run.device.startswith("cuda")
    t = time.perf_counter()
    run.window(args.seconds, trace=bool(args.trace))
    phases = {"window_and_profile_s": time.perf_counter() - t}
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": run.cell["chips"],
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0,
    }
    t = time.perf_counter()
    metrics = run.read("per_layer" if args.trace else "end_to_end")
    phases["metrics_s"] = time.perf_counter() - t
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": device, "host": layers.host(run)}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.slice_s()
        result["breakdown"] = run.trace.breakdown()
        run.trace = None
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = run.judge()
    phases["judge_s"] = time.perf_counter() - t
    phases["setup"] = getattr(run, "setup_phases", {})
    result["phases"] = phases
    result["correct"] = H.correct(checks)
    result["checks"] = checks
    return result


def main(argv=None, device: str = "cuda", require_cuda: bool = True, root: str = H.ROOT) -> int:
    args = parse_args(argv)
    try:
        run = setup(args, device, require_cuda, root)
    except SystemExit as e:
        return int(e.code)
    result = measure(run, args)
    banned = H.banned_modules()
    if banned:
        print(f"jpegbench: the process holds {', '.join(banned)}; no result", file=sys.stderr)
        return 1
    if run.error:
        print(f"jpegbench: a request failed: {run.error}", file=sys.stderr)
    for line in H.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
