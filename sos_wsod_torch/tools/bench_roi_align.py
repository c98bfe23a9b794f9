"""The multi-level ROIAlign forward kernel (csrc/roi_align_fwd.cu) against its
plain version at the FPN box head's shapes, on one GPU.

    python -m sos_wsod_torch.tools.bench_roi_align [--iters 20] [--seed 0]

The inputs (``fpn_inputs``): p2-p5 of a 704 x 960 canvas, 256 channels
(176x240, 88x120, 44x60, 22x30), and 1000 proposals inside the 688 x 917
image with sides drawn log-uniform from 8 to 900 px (cut to the image), so
every level gets boxes; 5% of the slots invalid. In bfloat16 and float32 it checks that the
kernel's output equals the plain version's (torch.equal) and prints the
median CUDA-event time beside the bound and the plain version's time.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..kernels import roi_align as kernel
from ..models.roi_heads.standard import assign_boxes_to_levels
from ..ops.roi_align import roi_align_levels_reference
from .measure import bound_ms, card_line, cuda_ms

CANVAS = (704, 960)
IMAGE_HW = (688, 917)
STRIDES = (4, 8, 16, 32)
NUM_ROIS = 1000
CHANNELS = 256


def fpn_inputs(device, dtype, seed: int, p: int = NUM_ROIS, c: int = CHANNELS,
               canvas: Tuple[int, int] = CANVAS, image_hw: Tuple[int, int] = IMAGE_HW):
    """(features per level (H_l, W_l, C), boxes (P, 4) f32, valid (P,),
    level (P,) int32, spatial scales)."""
    rng = np.random.default_rng(seed)
    feats: List[torch.Tensor] = []
    for s in STRIDES:
        hw = (-(-canvas[0] // s), -(-canvas[1] // s))
        feats.append(torch.from_numpy(rng.standard_normal((*hw, c), dtype=np.float32))
                     .to(device=device, dtype=dtype))
    ih, iw = image_hw
    side = np.minimum(np.exp(rng.uniform(np.log(8), np.log(900), (p, 2))), [iw, ih])
    x1 = rng.uniform(0, iw - side[:, 0])
    y1 = rng.uniform(0, ih - side[:, 1])
    boxes = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], 1).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(device)
    valid = torch.from_numpy(rng.uniform(0, 1, p) > 0.05).to(device)
    level = assign_boxes_to_levels(boxes, 2, 5)
    return feats, boxes, valid, level, [1.0 / s for s in STRIDES]


def check(feats, boxes, valid, level, scales) -> float:
    """Kernel against the plain version on the same inputs; raises unless
    torch.equal. Returns the max abs difference (0)."""
    got = kernel.roi_align_fwd_cuda(feats, boxes, valid, level, scales).permute(0, 3, 1, 2)
    want = roi_align_levels_reference(feats, boxes, valid, level, scales)
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"ROIAlign kernel differs from the plain version in {n} of "
                             f"{got.numel()} elements")
    return float((got.float() - want.float()).abs().max())


def run(device, iters: int = 20, seed: int = 0) -> Dict[str, dict]:
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        feats, boxes, valid, level, scales = fpn_inputs(device, dtype, seed)
        err = check(feats, boxes, valid, level, scales)
        ms = cuda_ms(lambda: kernel.roi_align_fwd_cuda(feats, boxes, valid, level, scales), iters)
        plain_ms = cuda_ms(lambda: roi_align_levels_reference(feats, boxes, valid, level, scales),
                           3)
        per_level = torch.bincount(level[valid].long(), minlength=len(STRIDES)).tolist()
        out[str(dtype)[6:]] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms(kernel.traffic_bytes(feats, NUM_ROIS)),
                               "rois_per_level": per_level}
    return out


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    print(card_line(), flush=True)
    res = run(torch.device("cuda", 0), args.iters, args.seed)
    for dtype, r in res.items():
        print(f"[roi_align] {dtype} p2-p5 of {CANVAS} x {CHANNELS}, P={NUM_ROIS} (per level "
              f"{r['rois_per_level']}): equal to the plain version; kernel {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
