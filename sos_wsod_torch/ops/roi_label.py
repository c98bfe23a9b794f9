"""ROILabel: ROI labels and weights from each present class's top-scoring
seed proposals.

Counterpart of ``sos_wsod_tpu/ops/roi_label.py`` (d2-WSL's ROILabel kernel,
used by WSJDS in the reference):
 1. for each present class in class order, ``top_k`` distinct highest
    scoring valid ROIs become seeds; a seed taken for one class is not
    taken again for a later one (the first maximum wins, as ``argmax``);
 2. every ROI takes the class and weight of its max-IoU seed;
 3. IoU >= fg_thresh makes a foreground candidate, IoU in [bg_thresh_lo,
    bg_thresh_hi) a background one (class C); in a random order, the first
    num_pos + 1 foreground and num_neg + 1 background candidates keep their
    weight (the kernel tests its cap before it counts), the rest weigh 0;
 4. the weight is class_weights[class] when given, else the seed's score.

The caps are closed-form ranks over the permuted candidate flags, exact for
disjoint bands (bg_thresh_hi <= fg_thresh). The permutation comes from
``core/sampling.py:permutation`` with an explicit generator; the reference
shuffles with std::rand seeded by the wall clock. torch ops throughout; the
seed pick is a loop of C * top_k small steps with no host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import sampling


def roi_label(scores: torch.Tensor, iou: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor, generator: torch.Generator,
              class_weights: Optional[torch.Tensor] = None, *, top_k: int = 1,
              fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5, bg_thresh_lo: float = 0.1,
              num_pos: int = 32, num_neg: int = 96) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (R, C) or (R, C + 1), iou (R, R) between the ROIs, labels (C,)
    image-level, valid (R,) -> RL (R,) int32 in [0, C] (C: background) and
    RW (R,) float32."""
    if bg_thresh_hi > fg_thresh:
        raise ValueError("roi_label: the closed-form caps need bg_thresh_hi <= fg_thresh")
    r = scores.shape[0]
    c = labels.shape[0]
    dev = scores.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    s = torch.where(valid[:, None], scores[:, :c].float(), neg_inf)

    # 1. distinct top-k seeds, class-major
    taken = torch.zeros(r, dtype=torch.bool, device=dev)
    rows = torch.arange(r, device=dev)
    seed_n, seed_p, seed_ok = [], [], []
    for cls_k in range(c * top_k):
        cls = cls_k // top_k
        col = torch.where(taken, neg_inf, s[:, cls])
        idx = torch.argmax(col)
        score = col[idx]
        ok = (labels[cls] >= 0.5) & torch.isfinite(score)
        taken = taken | ((rows == idx) & ok)
        seed_n.append(idx)
        seed_p.append(score)
        seed_ok.append(ok)
    seed_n, seed_p, seed_ok = torch.stack(seed_n), torch.stack(seed_p), torch.stack(seed_ok)
    seed_c = torch.arange(c * top_k, device=dev) // top_k

    # 2. each ROI's max-IoU seed
    to_seeds = torch.where(seed_ok[None, :], iou[:, seed_n].float(), neg_inf)
    max_iou = to_seeds.amax(dim=1)
    best = torch.argmax(to_seeds, dim=1)          # the first maximum
    assign_c = seed_c[best]
    if class_weights is not None:
        assign_w = class_weights.float()[assign_c]
    else:
        assign_w = seed_p[best]

    # 3. the caps, in a random order
    perm = sampling.permutation(r, generator, dev)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(r, device=dev)
    fg_cand = valid & (max_iou >= fg_thresh)
    bg_cand = valid & ~fg_cand & (max_iou >= bg_thresh_lo) & (max_iou < bg_thresh_hi)
    fg_rank = torch.cumsum(fg_cand[perm].int(), 0)[inv]     # 1-based
    bg_rank = torch.cumsum(bg_cand[perm].int(), 0)[inv]
    fg = fg_cand & (fg_rank <= num_pos + 1)
    bg = bg_cand & (bg_rank <= num_neg + 1)

    zero = torch.zeros((), device=dev)
    rl = torch.where(bg, torch.full_like(assign_c, c), assign_c).int()
    rw = torch.where((fg | bg) & valid, assign_w, zero)
    return rl, rw
