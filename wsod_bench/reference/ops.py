"""Plain PyTorch operations of the reference: box geometry, greedy NMS,
ROI max pooling with its gradient, and the arithmetic of a lower precision.

Conventions, as published for detectron2 and torchvision:
  - boxes XYXY, area (x2 - x1) * (y2 - y1), IoU 0 where boxes do not meet;
  - greedy NMS: sort by score (stable, descending), keep a box unless a
    kept box before it overlaps it by IoU > threshold;
  - ROIPool (RoIPool of torchvision): a box's corners scaled and rounded
    half up, the box at least one cell, bin (i, j) the cells
    [floor(i * h / 7), ceil((i + 1) * h / 7)) from its corner, clipped to
    the map; a bin takes its window's maximum (0 if empty), times the
    proposal's objectness + 1; the gradient goes to the first maximum of
    the window in row-major order;
  - box deltas (10, 10, 5, 5), log-size deltas clamped at log(1000 / 16).
``Precision`` decides the arithmetic of every convolution and matrix
product: float32 (TF32 off), or float8 e4m3 for both operands, each tensor
scaled by its absolute maximum (per-tensor scaling), products summed in
float32: the reference in the precision below the system's bfloat16.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

SCALE_CLAMP = math.log(1000.0 / 16)
FP8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the precision holds it (float32 values)."""
        if self.name == "f32":
            return t
        return _Fp8Round.apply(t)

    def conv(self, x, w, b, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)

    def linear(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b)


class _Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale; the gradient passes
    through as it is (the operands of the backward products are the rounded
    tensors autograd saved)."""

    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().max().float().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4), (..., N, 4) -> (..., M, N)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(inter > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             thr: float) -> torch.Tensor:
    """Greedy NMS of each leading problem: (..., S, 4), (..., S), (..., S)
    -> keep (..., S) in input order. Sequential over the sorted boxes, one
    problem batch at a time on the device."""
    masked = torch.where(valid, scores, float("-inf"))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)
    s = b.shape[-2]
    over = (iou(b, b) > thr) & torch.ones(s, s, dtype=torch.bool, device=b.device).triu(1)
    keep = v.clone()
    # a box is kept iff valid and no kept box before it overlaps it; the
    # fixpoint from keep = valid reaches the greedy answer
    while True:
        new = v & ~(over & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(keep).scatter(-1, order, keep)


def bin_windows(boxes: torch.Tensor, valid: torch.Tensor, h: int, w: int, res: int,
                scale: float):
    """int64 (P, res) row starts and ends, then column starts and ends."""
    boxes = torch.where(valid[:, None], boxes, 0.0)
    r = torch.floor(boxes.float() * scale + 0.5).long()
    x1, y1 = r[:, 0].clamp(0, w + res), r[:, 1].clamp(0, h + res)
    x2, y2 = r[:, 2].clamp(-1, w + res), r[:, 3].clamp(-1, h + res)
    g = torch.arange(res, device=boxes.device)

    def bounds(start, size, limit):
        lo = torch.div(g[None] * size[:, None], res, rounding_mode="floor") + start[:, None]
        hi = torch.div((g[None] + 1) * size[:, None] + res - 1, res,
                       rounding_mode="floor") + start[:, None]
        return lo.clamp(0, limit), hi.clamp(0, limit)

    hs, he = bounds(y1, (y2 - y1 + 1).clamp(min=1), h)
    ws, we = bounds(x1, (x2 - x1 + 1).clamp(min=1), w)
    return hs, he, ws, we


class RoIPool(torch.autograd.Function):
    """feat (H, W, C) -> (P, res, res, C), times ``scale_rows`` (P,)."""

    @staticmethod
    def forward(ctx, feat, boxes, valid, scale_rows, res: int, spatial_scale: float):
        h, w, c = feat.shape
        hs, he, ws, we = bin_windows(boxes, valid, h, w, res, spatial_scale)
        p = boxes.shape[0]
        best = torch.full((p, res, res, c), float("-inf"), dtype=feat.dtype, device=feat.device)
        pos = torch.full((p, res, res, c), -1, dtype=torch.int64, device=feat.device)
        for dy in range(int((he - hs).max()) if p else 0):
            y = hs + dy
            yc, in_y = y.clamp(0, h - 1), y < he
            for dx in range(int((we - ws).max()) if p else 0):
                x = ws + dx
                xc = x.clamp(0, w - 1)
                inside = (in_y[:, :, None] & (x < we)[:, None, :])[..., None]
                v = feat[yc[:, :, None], xc[:, None, :]]
                take = inside & ((v > best) | (pos < 0))
                best = torch.where(take, v, best)
                pos = torch.where(take, ((yc * w)[:, :, None] + xc[:, None, :])[..., None], pos)
        live = ((he > hs)[:, :, None] & (we > ws)[:, None, :] & valid[:, None, None])[..., None]
        out = torch.where(live, best * scale_rows.to(feat.dtype)[:, None, None, None], 0.0)
        pos = torch.where(live, pos, -1)
        ctx.save_for_backward(pos, scale_rows)
        ctx.shape = feat.shape
        return out

    @staticmethod
    def backward(ctx, g):
        pos, scale_rows = ctx.saved_tensors
        h, w, c = ctx.shape
        gp = (g * scale_rows[:, None, None, None].to(g.dtype)).float()
        flat = torch.where(pos >= 0, pos * c + torch.arange(c, device=g.device), h * w * c)
        acc = torch.zeros(h * w * c + 1, dtype=torch.float32, device=g.device)
        acc.index_add_(0, flat.reshape(-1), gp.reshape(-1))
        return acc[:-1].reshape(h, w, c).to(g.dtype), None, None, None, None, None


def roi_pool(feat, boxes, valid, scale_rows, res: int = 7, spatial_scale: float = 1 / 8):
    return RoIPool.apply(feat, boxes, valid, scale_rows, res, spatial_scale)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """(N, K*4) deltas on (N, 4) boxes -> (N, K*4)."""
    n = deltas.shape[0]
    d = deltas.reshape(n, -1, 4)
    wd, ht = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    cx, cy = boxes[:, 0] + 0.5 * wd, boxes[:, 1] + 0.5 * ht
    pcx = d[..., 0] / weights[0] * wd[:, None] + cx[:, None]
    pcy = d[..., 1] / weights[1] * ht[:, None] + cy[:, None]
    pw = torch.exp(torch.clamp(d[..., 2] / weights[2], max=SCALE_CLAMP)) * wd[:, None]
    ph = torch.exp(torch.clamp(d[..., 3] / weights[3], max=SCALE_CLAMP)) * ht[:, None]
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph],
                       -1).reshape(n, -1)


def get_deltas(src: torch.Tensor, dst: torch.Tensor, weights=(10.0, 10.0, 5.0, 5.0)):
    """(N, 4), (N, 4) -> (N, 4); a width or height <= 0 counts as 1."""
    def whc(b):
        w, h = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
        w, h = torch.where(w > 0, w, 1.0), torch.where(h > 0, h, 1.0)
        return w, h, b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h

    sw, sh, sx, sy = whc(src)
    tw, th, tx, ty = whc(dst)
    return torch.stack([weights[0] * (tx - sx) / sw, weights[1] * (ty - sy) / sh,
                        weights[2] * torch.log(tw / sw), weights[3] * torch.log(th / sh)], -1)


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    lim = torch.stack([w, h, w, h]).to(boxes.dtype)
    return torch.minimum(boxes.clamp(min=0), lim)


def top_detections(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                   image_hw: torch.Tensor, score_thresh: float, nms_thresh: float,
                   topk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class NMS and the top k: boxes (P, K*4), scores (P, K) ->
    (boxes (D, 4), scores (D,), classes (D,)) of the kept, best first."""
    p, k = scores.shape
    b = clip_boxes(boxes.reshape(p, k, 4), image_hw[0], image_hw[1])
    ok = valid & torch.isfinite(boxes).all(1) & torch.isfinite(scores).all(1)
    cand = ok[:, None] & (scores > score_thresh)
    keep = nms_keep(b.transpose(0, 1), scores.T, cand.T, nms_thresh).T & cand
    flat = torch.where(keep, scores, float("-inf")).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:topk], idx[:topk]
    live = torch.isfinite(vals)
    vals, idx = vals[live], idx[live]
    return b.reshape(-1, 4)[idx], vals, idx % k


def rescale(boxes: torch.Tensor, image_hw: torch.Tensor, orig_hw: torch.Tensor) -> torch.Tensor:
    sy, sx = orig_hw[0] / image_hw[0], orig_hw[1] / image_hw[1]
    return clip_boxes(boxes * torch.stack([sx, sy, sx, sy]).to(boxes.dtype), orig_hw[0],
                      orig_hw[1])
