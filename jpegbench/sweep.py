"""Find an open-loop cell's knee: the highest arrival rate the port
sustains, by a sweep on the card.

    python3 -m jpegbench.sweep --workload <cell> --seed <n> --seconds <s> [--rates 20,40,...]

One set-up, then a closed loop (each frame decoded as soon as the last
is done: the service rate), then one open-loop window per rate (the
traffic file's ``sweep_rates`` unless --rates is given). Each line gives
the rate, the latencies, and whether a backlog grew: the mean wait before
service (start - due) of the window's last quarter of requests against
its first quarter's. The knee is the highest rate at which the last
quarter waits no more than the first quarter plus one median service
time and the p95 stays under five median service times. The cell's rate
is then written by hand into its traffic file at 0.8 of the knee.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

from . import harness as H
from . import run as R


def summary(run, rate: float, seconds: float) -> dict:
    recs = run.records
    lat = np.array([(r["end"] - r["due"]) * 1e3 for r in recs])
    svc = [(r["end"] - r["start"]) * 1e3 for r in recs]
    wait = np.array([(r["start"] - r["due"]) * 1e3 for r in recs])
    q = max(1, len(recs) // 4)
    late = [(r["start"] - r["due"]) * 1e3 for r in recs if r["idle"]]
    svc50 = statistics.median(svc)
    grew = float(wait[-q:].mean()) > float(wait[:q].mean()) + svc50
    return dict(rate=rate, requests=len(recs), failed=run.failed, seconds=seconds,
                elapsed_s=recs[-1]["end"] - run.t0, p50_ms=float(np.percentile(lat, 50)),
                p95_ms=float(np.percentile(lat, 95)), p99_ms=float(np.percentile(lat, 99)),
                service_p50_ms=svc50, wait_first_quarter_ms=float(wait[:q].mean()),
                wait_last_quarter_ms=float(wait[-q:].mean()), backlog_grew=grew,
                sustained=(not grew) and float(np.percentile(lat, 95)) <= 5 * svc50,
                lateness_p99_ms=float(np.percentile(late, 99)) if late else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m jpegbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", default="")
    args = ap.parse_args(argv)
    run = R.setup(argparse.Namespace(workload=args.workload, seed=args.seed), "cuda", True, H.ROOT)
    rates = [float(r) for r in args.rates.split(",") if r] or run.traffic["sweep_rates"]
    lines = []
    # The service rate: the same frames back to back.
    run.reset()
    cfg = run.port.DecodeConfig(to_numpy=False)
    t = time.perf_counter()
    n = 0
    while time.perf_counter() - t < args.seconds:
        run.port.decode(run.pool[n % len(run.pool)].data, cfg, device=run.device)
        run.sync()
        n += 1
    lines.append(dict(closed_loop_per_s=n / (time.perf_counter() - t), requests=n))
    for rate in rates:
        run.reset()
        run.loop.window(run, args.seconds, rate=rate)
        lines.append(summary(run, rate, args.seconds))
    sustained = [ln["rate"] for ln in lines[1:] if ln["sustained"]]
    lines.append(dict(knee_per_s=max(sustained) if sustained else None,
                      rate_at_0_8=0.8 * max(sustained) if sustained else None,
                      device=run.torch.cuda.get_device_name(0)))
    for ln in lines:
        print(json.dumps(ln), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
