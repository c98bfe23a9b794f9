"""CSC: each ROI's contrast in the class peak gradient (CPG) maps.

Counterpart of ``sos_wsod_tpu/ops/csc.py`` (the reference's csc CUDA
kernel, csc_cuda.cu:184-548). For every present class (label >= 0.5) the
class's CPG map is binarised at ``fg_threshold`` and turned into an integral
image; each ROI is scored by the frame/context contrast

    score = sum(frame) / sqrt(area(frame)) - sum(context) / sqrt(area(context))

where frame = roi minus roi / context_scale and context = roi * context_scale
minus roi, the corners rounded as the kernel rounds them. The scores are
normalised per class (positives by the maximum, negatives by |minimum|; all
ones when no score is positive) and blended with the image-level score:
W = pred * W + (1 - pred). Absent classes and invalid ROIs keep W = 1.

Batched over the classes as plain tensor ops (the binary maps, two cumsums
each, four-corner lookups for each ROI), as in the JAX package; no
gradient. Every division is a true division of two tensors on the ROIs'
device: torch computes a tensor divided by a Python number on the card as a
product with the reciprocal, and a corner at .5 after ``/ context_scale``
could then round the other way there. The square roots of the areas are
taken in f64 and rounded to f32, which gives the correctly rounded f32 root:
torch's f32 ``sqrt`` on the card is not (chip_smoke.py's phase 16 counts the
integers whose root differs from the CPU's), and the card's W then differed
from the CPU's.

``csc_constraint`` is the reference's _CSCConstraint: Y = X * clamp(W),
with the gradient dX = dY * clamp(W) and none to W.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.full_like(a, b)


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    """C's round() for the non-negative coordinates used here."""
    return torch.floor(x + 0.5)


def _contrast_scores(cpgs: torch.Tensor, rois: torch.Tensor, fg_threshold: float,
                     area_sqrt: bool, context_scale: float) -> torch.Tensor:
    """(C, H, W) maps, (N, 4) rois -> (C, N) contrast scores."""
    c, h, w = cpgs.shape
    binary = (cpgs >= fg_threshold).float()
    ipad = F.pad(binary.cumsum(1).cumsum(2), (1, 0, 1, 0)).reshape(c, -1)   # (C, (H+1)(W+1))

    wstart = _round_half_up(rois[:, 0]).clamp(0, w - 1)
    hstart = _round_half_up(rois[:, 1]).clamp(0, h - 1)
    wend = _round_half_up(rois[:, 2]).clamp(0, w - 1)
    hend = _round_half_up(rois[:, 3]).clamp(0, h - 1)
    width, height = wend - wstart, hend - hstart
    wcenter, hcenter = _div(wend + wstart, 2.0), _div(hend + hstart, 2.0)
    w_in, h_in = _div(_div(width, context_scale), 2.0), _div(_div(height, context_scale), 2.0)
    w_out, h_out = _div(width * context_scale, 2.0), _div(height * context_scale, 2.0)
    inner = (_round_half_up(hcenter - h_in), _round_half_up(wcenter - w_in),
             _round_half_up(hcenter + h_in), _round_half_up(wcenter + w_in))
    outer = (_round_half_up((hcenter - h_out).clamp(min=0.0)),
             _round_half_up((wcenter - w_out).clamp(min=0.0)),
             _round_half_up((hcenter + h_out).clamp(max=h - 1.0)),
             _round_half_up((wcenter + w_out).clamp(max=w - 1.0)))
    roi = (hstart, wstart, hend, wend)

    def rect_sum(y0, x0, y1, x1):
        y0, x0, y1, x1 = (v.long() for v in (y0, x0, y1, x1))
        at = lambda y, x: ipad[:, y * (w + 1) + x]      # noqa: E731
        return at(y1 + 1, x1 + 1) - at(y1 + 1, x0) - at(y0, x1 + 1) + at(y0, x0)

    def area(y0, x0, y1, x1):
        return (y1 - y0 + 1) * (x1 - x0 + 1)

    sum_roi, sum_inner, sum_outer = rect_sum(*roi), rect_sum(*inner), rect_sum(*outer)
    area_frame = (area(*roi) - area(*inner)).clamp(min=1.0)
    area_context = (area(*outer) - area(*roi)).clamp(min=1.0)
    if area_sqrt:   # the f32 square root correctly rounded, through f64 (see the docstring)
        area_frame = area_frame.double().sqrt().float()
        area_context = area_context.double().sqrt().float()
    return (sum_roi - sum_inner) / area_frame - (sum_outer - sum_roi) / area_context


def _normalize(scores: torch.Tensor, preds: torch.Tensor, active: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Per-class normalisation and the blend with the image score; (C, N)."""
    s = torch.where(valid, scores, 0.0)
    max_value = s.amax(dim=1, keepdim=True).clamp(min=0.0)
    min_value = s.amin(dim=1, keepdim=True).clamp(max=0.0)
    pos_div = torch.where(max_value > 0, max_value, torch.ones_like(max_value))
    neg_div = torch.where(min_value < 0, -min_value, torch.ones_like(min_value))
    norm_pos = scores / pos_div
    norm_both = torch.where(scores > 0, norm_pos, scores / neg_div)
    ones = torch.ones_like(scores)
    w = torch.where((max_value > 0) & (min_value < 0), norm_both,
                    torch.where((max_value > 0) & (min_value == 0), norm_pos, ones))
    # pred * W + (1 - pred) rounded once, as the fused multiply-add that XLA
    # makes of it gives it: the f32 product is exact in f64, so only the sum
    # rounds there before the one rounding to f32 (the same on the card)
    p64 = preds[:, None].double()
    w = (p64 * w.double() + (1.0 - preds[:, None]).double()).float()
    w = torch.where(valid, w, 1.0)
    return torch.where(active[:, None], w, ones)


@torch.no_grad()
def csc(cpgs: torch.Tensor, labels: torch.Tensor, preds: torch.Tensor, rois: torch.Tensor,
        valid: torch.Tensor, *, fg_threshold: float = 0.1, area_sqrt: bool = True,
        context_scale: float = 1.8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cpgs (C, H, W) class peak gradient maps, labels (C,) one-hot, preds
    (C,) image-level class scores, rois (N, 4) XYXY in image coordinates,
    valid (N,) -> (W (N, C) in [-1, 1], PL = labels (C,), NL = zeros (C,)),
    f32, as the reference's Function returns them."""
    cpgs, rois, preds = cpgs.float(), rois.float(), preds.float()
    scores = _contrast_scores(cpgs, rois, fg_threshold, area_sqrt, context_scale)
    w = _normalize(scores, preds, labels >= 0.5, valid[None, :])
    pl = labels.float()
    return w.t(), pl, torch.zeros_like(pl)


def csc_constraint(x: torch.Tensor, w: torch.Tensor, polar: bool) -> torch.Tensor:
    """Y = X * clamp(W): W's positive part (``polar``) or its negated
    negative part; the gradient flows to X only."""
    w_ = w.clamp(min=0.0) if polar else -w.clamp(max=0.0)
    return x * w_.detach()
