"""Readings of a cell's comparison over many seeds in one process, to set
its limits: the system's sound runs (a short window each) and the control
(``control.py``) on the same seeds.

    python3 -m wsod_bench.calibrate --workload <cell> --seeds 1 2 3 [--seconds 1] [--look]

Prints one JSON line a seed: every number the cell's driver computes, for
the system and for the control, beside the limits; with ``--look``, what
the driver's look found (training: the reference again, following the
system's seed weights too). The driver's log goes to standard error. The benchmark's own
runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import control, run, spec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args()
    run.pin_caches(spec.ROOT)
    for seed in args.seeds:
        cell = spec.load(spec.ROOT / "BENCHMARK.json", args.workload)
        ctx = run.Context(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                          log=lambda msg: print(msg, file=sys.stderr, flush=True),
                          look=args.look)
        out = cell.driver().run(ctx)
        low = control.numbers(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "system": out["numbers"],
                          "control": low, "limits": cell.limits, "look": out.get("look")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
