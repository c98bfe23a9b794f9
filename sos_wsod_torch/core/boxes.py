"""Box geometry on plain ``(..., 4)`` XYXY float tensors.

Counterpart of ``sos_wsod_tpu/core/boxes.py``: raw tensors plus explicit
validity masks instead of a Boxes class. The pairwise functions broadcast over
leading batch dimensions, so one call serves a batch of per-class problems.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# clamp for dw/dh in apply_deltas (d2 box_regression.py:10)
SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,). d2 convention: (x2-x1)*(y2-y1), no +1."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., M, 4), (..., N, 4) -> (..., M, N) intersection areas (clamped at 0)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """d2 pairwise_iou: IoU=0 where the intersection is 0 (also for empty boxes)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    inter = pairwise_intersection(boxes1, boxes2)
    union = area1[..., :, None] + area2[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, inter / safe, torch.zeros_like(inter))


def pairwise_iou_wsl(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """d2-WSL's signed inner/outer overlap ratio, (..., M, 4), (..., N, 4) ->
    (..., M, N): inner area / outer area, negative where the boxes do not
    overlap (an inner side not > 0), 0 where the outer area is 0."""
    lo1, hi1 = boxes1[..., :, None, :2], boxes1[..., :, None, 2:]
    lo2, hi2 = boxes2[..., None, :, :2], boxes2[..., None, :, 2:]
    outer_wh = (torch.maximum(hi1, hi2) - torch.minimum(lo1, lo2)).abs()
    outer = outer_wh[..., 0] * outer_wh[..., 1]
    inner_wh = torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)
    sign = torch.where((inner_wh > 0).all(dim=-1), 1.0, -1.0)
    inner = inner_wh[..., 0].abs() * inner_wh[..., 1].abs()
    return torch.where(outer > 0, inner / outer * sign, torch.zeros_like(outer))


def clip_boxes(boxes: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Clip XYXY boxes (..., 4) to [0, w] x [0, h] (d2 Boxes.clip); h, w
    are 0-d tensors."""
    lim = torch.stack([w, h, w, h]).to(boxes.dtype)
    return torch.minimum(boxes.clamp(min=0), lim)


def apply_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
) -> torch.Tensor:
    """Decode deltas (N, K*4) against boxes (N, 4) -> (N, K*4), with the
    dw/dh SCALE_CLAMP of d2's Box2BoxTransform.apply_deltas."""
    n, k4 = deltas.shape
    d = deltas.reshape(n, k4 // 4, 4)
    wx, wy, ww, wh = weights
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(d[..., 3] / wh, max=SCALE_CLAMP)
    pcx = dx * widths[:, None] + ctr_x[:, None]
    pcy = dy * heights[:, None] + ctr_y[:, None]
    pw = torch.exp(dw) * widths[:, None]
    ph = torch.exp(dh) * heights[:, None]
    out = torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
    return out.reshape(n, k4)


def get_deltas(
    src_boxes: torch.Tensor,
    target_boxes: torch.Tensor,
    weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
) -> torch.Tensor:
    """Encode target boxes relative to src boxes, (N, 4), (N, 4) -> (N, 4),
    as d2's Box2BoxTransform.get_deltas. Degenerate widths or heights
    (<= 0) are taken as 1.0 instead of asserting: padded slots carry dummy
    boxes and the loss masks them."""
    wx, wy, ww, wh = weights

    def wh_ctr(b):
        w = b[..., 2] - b[..., 0]
        h = b[..., 3] - b[..., 1]
        w = torch.where(w > 0, w, torch.ones_like(w))
        h = torch.where(h > 0, h, torch.ones_like(h))
        return w, h, b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h

    sw, sh, scx, scy = wh_ctr(src_boxes)
    tw, th, tcx, tcy = wh_ctr(target_boxes)
    return torch.stack([wx * (tcx - scx) / sw, wy * (tcy - scy) / sh,
                        ww * torch.log(tw / sw), wh * torch.log(th / sh)], dim=-1)


def unique_boxes_keep_mask(boxes: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Host-side keep mask of the first occurrence of each box, by d2-WSL's
    Boxes.unique_boxes hash: round(box * scale) . [1, 1e3, 1e6, 1e9]."""
    v = np.array([1.0, 1e3, 1e6, 1e9])
    hashes = np.round(np.asarray(boxes, dtype=np.float64) * scale).dot(v).astype(np.int64)
    _, index = np.unique(hashes, return_index=True)
    keep = np.zeros(boxes.shape[0], dtype=bool)
    keep[np.sort(index)] = True
    return keep
