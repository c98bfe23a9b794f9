"""Exact greedy NMS as a fixed-shape keep mask, batched over problems.

Counterpart of ``nms_mask`` in ``sos_wsod_tpu/ops/nms.py`` (torchvision
``nms`` semantics): sort by score descending (stable), keep the best, suppress
every later box whose IoU with a kept box is strictly greater than the
threshold. The greedy scan is the fixpoint of

    keep[j] = valid[j] and not any_{i<j}( keep[i] and iou(i, j) > thr )

over score-sorted order; suppression flows only from earlier to later boxes,
so iterating from keep = valid converges to the greedy answer. Leading batch
dimensions are independent problems solved in one loop, so the host reads one
convergence flag per iteration for the whole batch, not one per problem.
"""
from __future__ import annotations

import torch

from ..core.boxes import pairwise_iou


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """boxes (..., S, 4) XYXY, scores (..., S), valid (..., S) bool ->
    keep (..., S) bool in the original input order."""
    s = boxes.shape[-2]
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)
    upper = torch.ones((s, s), dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (pairwise_iou(b, b) > iou_threshold) & upper  # [i, j]: i suppresses j
    keep = v
    while True:
        suppressed = (suppress & keep[..., :, None]).any(dim=-2)
        new_keep = v & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return torch.zeros_like(keep).scatter(-1, order, keep)
