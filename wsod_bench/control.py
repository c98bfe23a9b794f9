"""The control of the comparison that decides ``correct``: the plain
reference in float8 (the precision below the system's bfloat16) put in the
system's place, against the reference in float32, on a cell's own inputs
and sizes.

    python3 -m wsod_bench.control --workload <cell> --seeds 11 12 13

Prints, for each seed, the cell's numbers as the control reads them beside
the limits; each seed must fail at least one. The benchmark's own runs do
not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import compare, spec, synth, weights as weights_mod
from .run import Context


def numbers(cell: spec.Cell, seed: int, device: str, overrides=()) -> dict:
    ctx = Context(cell, seed, 0.0, False, device, time.perf_counter(), list(overrides))
    fam = cell.model()
    tree = ctx.port_cfg().to_dict()
    st = fam.settings(tree)
    shapes = fam.param_shapes(st)
    dicts = synth.dataset_dicts(cell.traffic, st["num_classes"], seed)
    dev = torch.device(device)

    def w():
        return weights_mod.make(shapes, cell.config["init"], seed, dev)

    if cell.traffic["driver"] == "train":
        n = int(cell.traffic["check_steps"])
        low = fam.reference_train(dicts, tree, w(), n, dev, "fp8")
        f32 = fam.reference_train(dicts, tree, w(), n, dev, "f32", seeds=low[3])
        return {**compare.train_numbers(*low[:3], *f32[:3]), "mining_gap": 0.0}
    rng = torch.Generator().manual_seed(int(seed))
    k = min(int(cell.traffic["check_images"]), len(dicts))
    picks = {int(i): dicts[int(i)] for i in torch.randperm(len(dicts), generator=rng)[:k]}
    low = fam.reference_predict(picks, tree, w(), dev, "fp8")
    program = {i: (tuple(t.cpu().numpy() for t in low[i][0]), fam.kept_of_reference(low[i]))
               for i in picks}
    given = {i: program[i][1] for i in picks} if program[next(iter(picks))][1] else None
    f32 = fam.reference_predict(picks, tree, w(), dev, "f32", proposals=given)
    return fam.check_numbers(program, f32, list(picks))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = spec.load(spec.ROOT / "BENCHMARK.json", args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = numbers(cell, seed, "cuda")
        failed = {k: got[k] > float(v) for k, v in cell.limits.items()}
        failed_all &= any(failed.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "limits": cell.limits, "fails": failed,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
