"""Exact greedy NMS as a fixed-shape keep mask, batched over problems.

Counterpart of ``sos_wsod_tpu/ops/nms.py`` (torchvision ``nms`` semantics):
sort by score descending (stable), keep the best, suppress every later box
whose IoU with a kept box is strictly greater than the threshold. Leading
batch dimensions are independent problems.

The stable sort, the gathers of the sorted boxes and valid flags and the
scatter back to input order are torch. The greedy keep in sorted order is
computed, for a CUDA tensor, by the hand-written kernels of
``kernels/nms.py`` (suppression bitmasks, then one sweep per problem, no
host sync); for a CPU tensor by the plain version, the fixpoint of

    keep[j] = valid[j] and not any_{i<j}( keep[i] and iou(i, j) > thr )

over score-sorted order. Suppression flows only from earlier to later boxes,
so iterating from keep = valid converges to the greedy answer; the host
reads one convergence flag per iteration for the whole batch.
"""
from __future__ import annotations

import torch

from ..core.boxes import pairwise_iou
from ..kernels.nms import nms_keep_sorted_cuda


def greedy_keep_sorted_reference(b: torch.Tensor, v: torch.Tensor,
                                 iou_threshold: float) -> torch.Tensor:
    """The plain version: b (..., S, 4) boxes and v (..., S) valid flags in
    score-sorted order -> keep (..., S) bool in that order."""
    s = b.shape[-2]
    upper = torch.ones((s, s), dtype=torch.bool, device=b.device).triu(1)
    return greedy_keep_from_suppression((pairwise_iou(b, b) > iou_threshold) & upper, v)


def greedy_keep_from_suppression(suppress: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain fixpoint over a suppression matrix: suppress (..., S, S)
    bool, [i, j] set where box i suppresses box j (j > i only, score-sorted
    order), v (..., S) valid -> keep (..., S) bool."""
    keep = v
    while True:
        suppressed = (suppress & keep[..., :, None]).any(dim=-2)
        new_keep = v & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def greedy_keep_sorted(b: torch.Tensor, v: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The greedy keep in sorted order: the kernels for a CUDA tensor, the
    plain version for a CPU tensor."""
    if b.is_cuda:
        lead = b.shape[:-2]
        s = b.shape[-2]
        keep = nms_keep_sorted_cuda(b.reshape(-1, s, 4).contiguous(),
                                    v.reshape(-1, s).contiguous(), iou_threshold)
        return keep.reshape(*lead, s)
    if b.device.type == "cpu":
        return greedy_keep_sorted_reference(b, v, iou_threshold)
    raise ValueError(f"nms_mask: no implementation for device {b.device}")


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """boxes (..., S, 4) XYXY, scores (..., S), valid (..., S) bool ->
    keep (..., S) bool in the original input order."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)
    keep = greedy_keep_sorted(b, v, iou_threshold)
    return torch.zeros_like(keep).scatter(-1, order, keep)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Per-class NMS by the coordinate-offset trick (torchvision
    batched_nms): each class id of ``idxs`` is shifted into its own island
    by ``max_coord + 1``, the maximum over valid coordinates only, so one
    class-agnostic NMS suffices. boxes (S, 4), scores (S,), idxs (S,),
    valid (S,) -> keep (S,)."""
    max_coord = torch.where(valid[:, None], boxes, torch.zeros_like(boxes)).max()
    offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)
    return nms_mask(boxes + offsets[:, None], scores, valid, iou_threshold)


def keep_top_k(scores: torch.Tensor, keep: torch.Tensor, k: int) -> torch.Tensor:
    """Restrict a keep mask to its top-k entries by score (torch
    ``keep[:topk]`` on torchvision's score-ordered keep list): the entries
    above the k-th kept score, plus those tied with it in index order up to
    the budget."""
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    kth = torch.sort(masked, descending=True, stable=True).values[k - 1]
    above = masked > kth
    at = masked == kth
    budget = k - (above & keep).sum()
    at_rank = torch.cumsum(at.to(torch.int32), 0) * at.to(torch.int32)
    take_at = at & (at_rank <= budget)
    return keep & (above | take_at) & (masked > float("-inf"))
