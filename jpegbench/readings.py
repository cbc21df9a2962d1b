"""The readings that a cell's correctness limit is set from, in one
process: the program's reading on each of a dozen seeds or more, and the
control's on the first few.

    python3 -m jpegbench.readings --workload <cell> --seeds a,b,... --seconds <s> [--control 3]

For each seed the cell's pool is made anew and a window of `seconds` runs
at the cell's own load; the sample the run keeps is judged against the
plain reference (the program's reading, which sound runs keep at 0
mismatched bytes), and for the first `--control` seeds the reference
decoded with the float IDCT stands in the program's place on the same
sample (the control's reading, which has to fail). The benchmark's own
runs never run the control. One JSON line per seed goes to standard
output.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness as H
from . import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m jpegbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    run = R.setup(argparse.Namespace(workload=args.workload, seed=seeds[0]), "cuda", True, H.ROOT)
    for n, seed in enumerate(seeds):
        if n:
            run.seed = seed
            with H.Workers(H.WORKERS) as workers:
                run.pool = run.start_pool(workers).get()
        run.window(args.seconds)
        line = dict(seed=seed, attempted=run.attempted, program=run.judge())
        if n < args.control:
            line["control_float_idct"] = run.judge(control="float")
        line["correct"] = H.correct(line["program"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
