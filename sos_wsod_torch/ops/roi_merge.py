"""ROIMerge: CMIL's continuation-clique clustering of the ROI scores.

Counterpart of ``sos_wsod_tpu/ops/roi_merge.py`` (the reference's ROIMerge
kernel, used by CMIL's MIL head). A greedy, sequential clique forming over
the top 200 ROIs by score, with the continuation threshold

    lambda(iter) = (log(t + .01) - log(.01)) / (log(max_epoch + .01) - log(.01)),
    t = cur_iter / size_epoch,

then the mean of each clique's cls and det scores; the backward spreads a
clique's gradient uniformly over its members (grad / clique size).

The assignment (``roi_merge_assign``) runs on the host in numpy, as the
reference does; ``roi_merge`` copies to the host only what it reads: the
(R,) scores and the IoU of the top-200 rows and columns in score order, a
(200, 200) block gathered on the device, not the (R, R) matrix. The mean and
its uniform split are ``index_add_`` on the scores' device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

TOP_K = 200      # ROIs that may found or join a clique
WINDOW = 40      # a clique's candidates: the next 40 in score order


def getlambda(iter_frac: float, max_iter: float) -> float:
    low = 0.01
    return (math.log(iter_frac + low) - math.log(low)) / (math.log(max_iter + low) - math.log(low))


def score_order(scores: np.ndarray) -> np.ndarray:
    """ROI indices by descending score, ties in index order."""
    return np.argsort(-scores, kind="stable")


def roi_merge_assign(scores: np.ndarray, iou: np.ndarray, cur_iter: int, max_epoch: int,
                     size_epoch: int, order: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The clique of each ROI. scores (R,); iou is the (R, R) IoU matrix, or,
    with ``order`` (``score_order(scores)``), the (k, k) IoU of its first
    k = min(R, 200) ROIs in that order, the only entries read. ROIs past the
    top 200 and ROIs no clique took become singletons in index order.
    Returns (ids (R,) int32, counts (R,) int32: each clique's size, zero past
    the last clique)."""
    num_roi = scores.shape[0]
    top_k = min(num_roi, TOP_K)
    if order is None:
        order = score_order(scores)
        sub = iou[np.ix_(order[:top_k], order[:top_k])]
    else:
        sub = iou
    lam = getlambda(float(cur_iter) / float(size_epoch), float(max_epoch))
    ids = np.full(num_roi, -1, np.int32)
    cur_id = 0
    for t in range(top_k):
        if ids[order[t]] != -1:
            continue
        ids[order[t]] = cur_id
        members = [t]          # the clique's ranks, all inside its window
        for tt in range(t + 1, min(t + WINDOW, top_k)):
            if ids[order[tt]] == -1 and (sub[tt, members] >= lam).all():
                ids[order[tt]] = cur_id
                members.append(tt)
        cur_id += 1
    for n in range(num_roi):
        if ids[n] == -1:
            ids[n] = cur_id
            cur_id += 1
    counts = np.zeros(num_roi, np.int32)
    np.add.at(counts, ids, 1)
    return ids, counts


class _CliqueMean(torch.autograd.Function):
    """x (R, K) -> (R, K): row c the mean of the rows with ids == c, zero for
    a c no row has; the gradient of row i is that of row ids[i] over its
    clique's size."""

    @staticmethod
    def forward(ctx, x, ids, inv):
        ctx.save_for_backward(ids, inv)
        return torch.zeros_like(x).index_add_(0, ids, x * inv[:, None])

    @staticmethod
    def backward(ctx, g):
        ids, inv = ctx.saved_tensors
        return g[ids] * inv[:, None], None, None


def roi_merge(scores: torch.Tensor, iou: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
              cur_iter: int, max_epoch: int, size_epoch: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores (R,) ROI scores (no gradient); iou (R, R); c, d (R, K) cls and
    det scores. Returns (mc, md (R, K): the clique means, rows past the last
    clique zero; ids (R,) int64: each ROI's clique; counts (R,) int64: each
    clique's size, zero past the last)."""
    r = scores.shape[0]
    s = scores.detach().float().cpu().numpy()
    order = score_order(s)
    top = torch.from_numpy(order[:min(r, TOP_K)]).to(iou.device)
    sub = iou.detach()[top[:, None], top[None, :]].float().cpu().numpy()
    ids_np, counts_np = roi_merge_assign(s, sub, cur_iter, max_epoch, size_epoch, order)
    ids = torch.from_numpy(ids_np.astype(np.int64)).to(c.device)
    counts = torch.from_numpy(counts_np.astype(np.int64)).to(c.device)
    inv = 1.0 / counts[ids].clamp(min=1).to(c.dtype)
    return _CliqueMean.apply(c, ids, inv), _CliqueMean.apply(d, ids, inv), ids, counts
