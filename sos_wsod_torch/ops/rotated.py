"""Rotated-box IoU and rotated NMS.

Counterpart of ``sos_wsod_tpu/ops/rotated.py`` (detectron2's box_iou_rotated
and nms_rotated). Boxes are (cx, cy, w, h, angle in degrees), the angle the
box's counter-clockwise rotation in image coordinates.

The intersection of two rotated rectangles is the fixed 8-vertex
Sutherland-Hodgman clip of the JAX package: the first box's corners clipped
by the four half-planes of the second's edges, each normal turned towards
the second box's centroid (a sign of 0 taken as 1), the crossing point at
d1 / (d1 - d2) with the divisor kept off 0 by 1e-12, the emitted vertices
compacted by a scatter-add into 8 slots. Every pair is computed at once,
in chunks of ``PAIR_CHUNK`` pairs: torch ops, on the card as on the CPU.
Every step is an IEEE f32 operation of its own, which the card and the
CPU round alike, so that the two give the same bits: the angle's cosine and
sine are taken in f64 and rounded to f32 (the f32 functions of the two
differ in the last bits), and the centroid and the polygon's area are sums
in a fixed order. The clip itself is ill-conditioned where edges nearly
coincide (a box against itself, near-duplicates), so an f32 implementation
that rounds otherwise, the JAX op's on another device among them, agrees
with this one only to rounding amplified there.

Rotated NMS sorts by score (stable), builds the suppression relation from
the rotated IoU matrix (box i suppresses a later box j where IoU(i, j) >
thr) and takes the greedy keep: on the card through kernel C's sweep
(``kernels/nms.py:nms_sweep_cuda``, the relation packed in its word
layout), on the CPU by the plain fixpoint
(``ops/nms.py:greedy_keep_from_suppression``). No loop over the boxes.
"""
from __future__ import annotations

import math

import torch

from ..kernels.nms import nms_sweep_cuda, suppression_words
from .nms import greedy_keep_from_suppression

MAX_VERTICES = 8
PAIR_CHUNK = 1 << 22


def box_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) cx, cy, w, h, degrees -> (..., 4, 2) corners, counter-clockwise."""
    cx, cy, w, h, a = boxes.unbind(-1)
    t = torch.deg2rad(a).double()
    cos, sin = torch.cos(t).float()[..., None], torch.sin(t).float()[..., None]
    dx = torch.stack([-w, w, w, -w], -1) * 0.5
    dy = torch.stack([-h, -h, h, h], -1) * 0.5
    px = cx[..., None] + dx * cos + dy * sin
    py = cy[..., None] - dx * sin + dy * cos
    return torch.stack([px, py], -1)


def _next_index(cnt: torch.Tensor, v: int) -> torch.Tensor:
    """(P, V) the index of each vertex's successor in a polygon of ``cnt``,
    clamped to the buffer as JAX clamps a gather: rounding can emit a 9th
    vertex where an exact clip would emit 8, and the count then passes V."""
    idx = torch.arange(v, device=cnt.device)
    return torch.where(idx + 1 >= cnt[:, None], 0, idx + 1).clamp(max=v - 1)


def _clip_by_halfplane(pts: torch.Tensor, cnt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor):
    """One Sutherland-Hodgman step for P polygons: keep a x + b y + c >= 0.
    pts (P, V, 2) padded, cnt (P,) vertex counts, a, b, c (P,) -> (pts, cnt)."""
    p, v, _ = pts.shape
    valid = torch.arange(v, device=pts.device) < cnt[:, None]
    p2 = torch.gather(pts, 1, _next_index(cnt, v)[..., None].expand(p, v, 2))
    a, b, c = a[:, None], b[:, None], c[:, None]
    d1 = a * pts[..., 0] + b * pts[..., 1] + c
    d2 = a * p2[..., 0] + b * p2[..., 1] + c
    in1, in2 = d1 >= 0, d2 >= 0
    diff = d1 - d2
    t = d1 / torch.where(diff.abs() > 1e-12, diff, torch.full_like(diff, 1e-12))
    inter = pts + t[..., None] * (p2 - pts)
    # each edge emits its first point if inside, then the crossing if it
    # crosses; the kept entries land in ascending slots (a rectangle clipped
    # by a rectangle has at most 8 vertices), the dropped add zeros
    flat_pts = torch.stack([pts, inter], dim=2).reshape(p, 2 * v, 2)
    flat_keep = torch.stack([valid & in1, valid & (in1 != in2)], dim=2).reshape(p, 2 * v)
    pos = torch.cumsum(flat_keep.int(), 1) - 1
    tgt = torch.where(flat_keep, pos.clamp(0, v - 1), v - 1).long()
    src = torch.where(flat_keep[..., None], flat_pts, torch.zeros_like(flat_pts))
    out = torch.zeros_like(pts).scatter_add_(1, tgt[..., None].expand(p, 2 * v, 2), src)
    return out, flat_keep.int().sum(1)


def _polygon_area(pts: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    p, v, _ = pts.shape
    valid = torch.arange(v, device=pts.device) < cnt[:, None]
    nxt = torch.gather(pts, 1, _next_index(cnt, v)[..., None].expand(p, v, 2))
    cross = pts[..., 0] * nxt[..., 1] - nxt[..., 0] * pts[..., 1]
    return _sum_in_order(torch.where(valid, cross, torch.zeros_like(cross))).abs() * 0.5


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """(P, V) -> (P,): ((x0 + x1) + x2) + ..., the same bits on any device."""
    total = x[:, 0]
    for i in range(1, x.shape[1]):
        total = total + x[:, i]
    return total


def _intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """c1, c2 (P, 4, 2) corners of P pairs of rectangles -> (P,) areas."""
    p = c1.shape[0]
    pts = torch.zeros((p, MAX_VERTICES, 2), dtype=torch.float32, device=c1.device)
    pts[:, :4] = c1
    cnt = torch.full((p,), 4, dtype=torch.int32, device=c1.device)
    centroid = torch.stack([_sum_in_order(c2[..., 0]), _sum_in_order(c2[..., 1])], -1) * 0.25
    for i in range(4):
        q0, q1 = c2[:, i], c2[:, (i + 1) % 4]
        a = q1[:, 1] - q0[:, 1]
        b = q0[:, 0] - q1[:, 0]
        c = -(a * q0[:, 0] + b * q0[:, 1])
        s = torch.sign(a * centroid[:, 0] + b * centroid[:, 1] + c)
        s = torch.where(s == 0, torch.ones_like(s), s)
        pts, cnt = _clip_by_halfplane(pts, cnt, a * s, b * s, c * s)
    return _polygon_area(pts, cnt)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) exact rotated IoU, f32."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1, c2 = box_to_corners(boxes1), box_to_corners(boxes2)
    inter = boxes1.new_zeros((n, m))
    rows = max(1, PAIR_CHUNK // max(m, 1))
    for r in range(0, n, rows):
        k = min(rows, n - r)
        inter[r:r + k] = _intersection_area(
            c1[r:r + k, None].expand(k, m, 4, 2).reshape(-1, 4, 2),
            c2[None].expand(k, m, 4, 2).reshape(-1, 4, 2)).view(k, m)
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def nms_rotated_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy rotated NMS: boxes (N, 5), scores (N,), valid (N,) -> keep (N,)
    bool in the input order. A box is suppressed by an earlier kept box (in
    score order) whose rotated IoU with it, IoU(earlier, later), exceeds the
    threshold."""
    n = boxes.shape[0]
    masked = torch.where(valid, scores.float(), torch.full_like(scores.float(), -math.inf))
    order = torch.sort(masked, descending=True, stable=True).indices
    b = boxes[order]
    v = valid[order]
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (pairwise_iou_rotated(b, b) > iou_threshold) & upper
    if boxes.is_cuda:
        keep = nms_sweep_cuda(suppression_words(suppress[None]), v[None].contiguous())[0]
    elif boxes.device.type == "cpu":
        keep = greedy_keep_from_suppression(suppress, v)
    else:
        raise ValueError(f"nms_rotated_mask: no implementation for device {boxes.device}")
    return torch.zeros_like(keep).scatter(0, order, keep)


def batched_nms_rotated(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                        valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Per-class rotated NMS by the coordinate-offset trick (d2
    batched_nms_rotated): each class's centres shifted by class id x (max
    |cx| + max |cy| + max (w + h) + 1), so that boxes of two classes never
    overlap. boxes (N, 5), scores, idxs, valid (N,) -> keep (N,)."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    boxes = boxes.float()
    span = (boxes[:, 0].abs().max() + boxes[:, 1].abs().max()
            + (boxes[:, 2] + boxes[:, 3]).max() + 1.0)
    shifted = torch.cat([boxes[:, :1] + (idxs.float() * span)[:, None], boxes[:, 1:]], dim=1)
    return nms_rotated_mask(shifted, scores, valid, iou_threshold)
