"""The greedy NMS kernels (csrc/nms.cu) against their plain version, at the
shapes the port runs them, on one GPU.

    python -m sos_wsod_torch.tools.bench_nms [--iters 20] [--seed 0]

For each shape of ``SHAPES`` it builds score-sorted problems with chains of
suppression, exact score ties, pairs exactly at the IoU threshold,
duplicates, empty boxes and invalid slots (``nms_case``), checks that the
kernels' keep masks equal the plain fixpoint's bit for bit, and prints the
median CUDA-event time of the two kernels beside the bound and the plain
version's time. The same inputs feed the CPU emulation of the kernels in
tests/test_torch_nms_plan.py.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels import nms as kernel
from ..ops.nms import greedy_keep_sorted_reference
from .measure import bound_ms, card_line, cuda_ms

# name -> (problems B, boxes S, IoU threshold)
SHAPES: Dict[str, Tuple[int, int, float]] = {
    "stage-1 inference": (20, 4096, 0.3),    # per-class NMS, models/postprocess.py
    "stage-1 mining": (1, 1024, 0.01),       # mist_mining, 4 times a step
    "stage-2 RPN": (1, 4495, 0.7),           # all levels, 704x960 canvas
    "stage-2 box head": (20, 1000, 0.5),     # per-class NMS of 1000 proposals
}


def _threshold_pair(rng, thr: float, x0: float, y0: float) -> np.ndarray:
    """Two boxes whose IoU is exactly the ratio m / n = thr (a box of width
    n and one of width m inside it, height 1), so the f32 IoU equals the
    threshold rounded to f32."""
    for n in (10, 100):
        m = round(thr * n)
        if m >= 1 and abs(m / n - thr) < 1e-12:
            return np.array([[x0, y0, x0 + n, y0 + 1], [x0, y0, x0 + m, y0 + 1]], np.float32)
    return np.array([[x0, y0, x0 + 10, y0 + 10], [x0, y0, x0 + 10, y0 + 10]], np.float32)


def nms_case(batch: int, s: int, thr: float, seed: int):
    """numpy boxes (B, S, 4) XYXY, scores (B, S) and valid (B, S), in random
    order: a third of each problem in chains whose neighbours overlap just
    above ``thr`` (so greedy keeps every other box, and the plain fixpoint
    needs one iteration a link), pairs exactly at the threshold, duplicates
    and empty boxes, the rest random; scores quantized to 0.05, so many tie;
    about 8% of the slots invalid."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, s, 4), np.float32)
    scores = np.zeros((batch, s), np.float32)
    for b in range(batch):
        rows, sc = [], []
        while len(rows) < s // 3:
            n = int(rng.integers(2, 13))
            w = float(rng.integers(8, 60))
            h = float(rng.integers(8, 60))
            d = w * (1 - thr) / (1 + thr) * 0.9   # IoU(k, k+1) just above thr
            x0, y0 = rng.uniform(0, 900, 2)
            top = rng.uniform(0.5, 1.0)
            for k in range(n):
                rows.append([x0 + k * d, y0, x0 + k * d + w, y0 + h])
                sc.append(top - 0.04 * k)
        while len(rows) < s // 3 + s // 10:
            rows.extend(_threshold_pair(rng, thr, *np.floor(rng.uniform(0, 900, 2))))
            sc.extend([rng.uniform(0, 1)] * 2)
        for _ in range(s // 40):
            x0, y0 = rng.uniform(0, 900, 2)
            rows.extend([[x0, y0, x0 + 20, y0 + 30]] * 2)       # a duplicate
            rows.append([x0, y0, x0, y0 + 5])                   # empty
            sc.extend(rng.uniform(0, 1, 3))
        while len(rows) < s:
            x0, y0 = rng.uniform(0, 900, 2)
            rows.append([x0, y0, x0 + rng.uniform(1, 120), y0 + rng.uniform(1, 120)])
            sc.append(rng.uniform(0, 1))
        perm = rng.permutation(s)
        boxes[b] = np.asarray(rows[:s], np.float32)[perm]
        scores[b] = np.round(np.asarray(sc[:s], np.float32) / 0.05)[perm] * 0.05
    valid = rng.uniform(0, 1, (batch, s)) > 0.08
    return boxes, scores.astype(np.float32), valid


def sorted_inputs(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """The boxes and valid flags in the stable score order of ops/nms.py."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4)).contiguous()
    return b, torch.gather(valid, -1, order).contiguous()


def check(b: torch.Tensor, v: torch.Tensor, thr: float) -> int:
    """Kernels against the plain fixpoint on the same sorted inputs; raises
    unless the keep masks are equal. Returns the number of boxes kept."""
    got = kernel.nms_keep_sorted_cuda(b, v, thr)
    want = greedy_keep_sorted_reference(b, v, thr)
    if not torch.equal(got, want):
        raise AssertionError(f"NMS kernel keep mask differs from the plain fixpoint in "
                             f"{int((got != want).sum())} of {got.numel()} boxes")
    return int(got.sum())


def run(device, iters: int = 20, seed: int = 0, shapes=None) -> Dict[str, dict]:
    """Check and time every shape; returns {name: {kept, ms, plain_ms,
    bound_ms}}."""
    out = {}
    for name, (batch, s, thr) in (shapes or SHAPES).items():
        boxes, scores, valid = (torch.from_numpy(a).to(device) for a in nms_case(batch, s, thr, seed))
        b, v = sorted_inputs(boxes, scores, valid)
        kept = check(b, v, thr)
        ms = cuda_ms(lambda: kernel.nms_keep_sorted_cuda(b, v, thr), iters)
        mask = kernel.nms_mask_words_cuda(b, thr)
        mask_ms = cuda_ms(lambda: kernel.nms_mask_words_cuda(b, thr), iters)
        sweep_ms = cuda_ms(lambda: kernel.nms_sweep_cuda(mask, v), iters)
        plain_ms = cuda_ms(lambda: greedy_keep_sorted_reference(b, v, thr), 3)
        out[name] = {"batch": batch, "s": s, "thr": thr, "kept": kept, "ms": ms,
                     "mask_ms": mask_ms, "sweep_ms": sweep_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms(kernel.traffic_bytes(batch, s))}
    return out


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    print(card_line(), flush=True)
    res = run(device, args.iters, args.seed)
    for name, r in res.items():
        print(f"[nms] {name} B={r['batch']} S={r['s']} thr={r['thr']}: bit-identical, "
              f"{r['kept']} kept; kernels {r['ms']:.4f} ms (mask {r['mask_ms']:.4f}, sweep "
              f"{r['sweep_ms']:.4f}), bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms",
              flush=True)
    return res


if __name__ == "__main__":
    main()
