"""Faults planted under a run of a cell, to see the comparison fail.

    python3 -m wsod_bench.faults --workload <cell> --fault <name> --seeds 1 2 3 [--seconds 3]

Each fault breaks the system's timed path where the work is done, for the
length of the run:
  - ``unchanged_state`` (training): the optimizer's step does nothing;
  - ``half_batch`` (training): the stage-1 head takes the first two of an
    image's four views, its losses the mean over those;
  - ``altered_answer``: training, the MIL loss a third higher where the
    head computes it; inference, the best detection's score of each image
    a third higher where post-processing computes it;
  - ``box_decode`` (inference): each class's boxes decoded with the next
    class's deltas, where the box head decodes them.
Prints each run's result line; exits 0 when every run reads ``correct``
false. The benchmark's own runs plant nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from . import run, spec


@contextlib.contextmanager
def _patched(obj, name, make):
    inner = getattr(obj, name)
    setattr(obj, name, make(inner))
    try:
        yield
    finally:
        setattr(obj, name, inner)


def planted(fault: str, kind: str):
    """The context that plants ``fault`` in the system for a cell of the
    driver ``kind`` ("train" or "infer")."""
    if fault == "unchanged_state" and kind == "train":
        import torch

        return _patched(torch.optim.SGD, "step", lambda inner: lambda self, *a, **k: None)
    if fault == "half_batch" and kind == "train":
        from sos_wsod_torch.models.heads.oicr_plus import OICRPlusHead

        return _patched(OICRPlusHead, "losses", lambda inner: (
            lambda self, pooled, boxes, *a, **k: inner(self, pooled[:2], boxes[:2], *a, **k)))
    if fault == "altered_answer" and kind == "train":
        from sos_wsod_torch.models.heads import oicr_plus

        return _patched(oicr_plus, "mil_loss", lambda inner: (
            lambda *a, **k: inner(*a, **k) * (4.0 / 3.0)))
    if fault == "altered_answer" and kind == "infer":
        from sos_wsod_torch.models.meta import rcnn_wsl
        from sos_wsod_torch.models.roi_heads import standard

        def make(inner):
            def post(*a, **k):
                det = inner(*a, **k)
                scores = det.scores.clone()
                scores[0] = scores[0] * (4.0 / 3.0)
                return type(det)(det.boxes, scores, det.classes, det.valid)
            return post

        stack = contextlib.ExitStack()
        for module in (rcnn_wsl, standard):   # the stage-1 and the stage-2 models' call
            stack.enter_context(_patched(module, "fast_rcnn_inference_single", make))
        return stack
    if fault == "box_decode" and kind == "infer":
        from sos_wsod_torch.models.heads import oicr_plus
        from sos_wsod_torch.models.roi_heads import standard

        def make(inner):
            def decode(deltas, boxes, *a, **k):
                n = deltas.shape[0]
                return inner(deltas.reshape(n, -1, 4).roll(1, 1).reshape(n, -1), boxes, *a, **k)
            return decode

        stack = contextlib.ExitStack()
        for module in (oicr_plus, standard):   # the stage-1 and the stage-2 box heads
            stack.enter_context(_patched(module, "apply_deltas", make))
        return stack
    raise ValueError(f"fault {fault!r} does not apply to a {kind} cell")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    all_false = True
    for seed in args.seeds:
        cell = spec.load(spec.ROOT / "BENCHMARK.json", args.workload)
        ctx = run.Context(cell, seed, args.seconds, False, "cuda", time.perf_counter())
        with planted(args.fault, cell.traffic["driver"]):
            line = run.run_cell(ctx)
        all_false &= not line["correct"]
        print(json.dumps({"fault": args.fault, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0 if all_false else 1


if __name__ == "__main__":
    sys.exit(main())
