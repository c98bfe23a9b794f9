"""ROILoopPool: ROI max pooling over three regions of each ROI, channels-last.

Counterpart of ``sos_wsod_tpu/ops/roi_loop_pool.py`` (the reference's
ROILoopPool CUDA kernel, context ratio 1.8). Output: (3P, PH, PW, C) stacked
[box; frame; context]:
  - box: ROIPool over the box's bin windows;
  - frame: the same windows without the cells strictly inside the inner box
    (the box's sides shrunk by 1/ratio about its center);
  - context: the bin windows of the outer box (sides times ratio, clipped
    to the map's extent in image coordinates), without the cells strictly
    inside the box.
"Strictly inside" a rectangle snapped to (h1, h2, w1, w2) is h1 < y < h2
and w1 < x < w2. The maximum starts at 0 (the kernel assumes non-negative
inputs), so a region with no positive cell gives 0 and pos -1; invalid slots
give 0 and pos -1 in all three rows. Each output is multiplied by
row_scale[p] cast to the feature dtype, like ``ops.roi_pool``.

The windows come from ``ops.roi_pool.bin_windows`` (its snap and its integer
bin bounds): the JAX op computes the same bounds without bin_windows' clamp
of the snapped box to one bin past the map, which changes nothing for boxes
inside the image (the JAX op's max table holds no larger windows either).
The exclusion rectangles are computed here in f32, in the JAX op's order.

The argmax is the first strictly larger value in an h-major scan of a bin's
kept cells. The backward is the ROIPool backward over the 3P rows
(``ops.roi_pool``: kernel A bwd on the card, its plain version on the CPU),
with the windows [box; box; outer] that hold each row's argmax and the row
scale repeated for the three blocks. JAX differentiates its sparse-table max
and ``maximum(o, 0)``, which split ties; on tie-free positive features the
two gradients are the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.roi_loop_pool import roi_loop_pool_fwd_cuda
from ..kernels.roi_pool_bwd import roi_pool_bwd_cuda
from .roi_pool import bin_windows, roi_pool_backward_reference

CONTEXT_RATIO = 1.8


def loop_windows(boxes: torch.Tensor, valid: torch.Tensor, h: int, w: int, ph_out: int,
                 pw_out: int, spatial_scale: float, context_ratio: float = CONTEXT_RATIO):
    """boxes (P, 4) XYXY image coords, valid (P,) -> int32 hs, he (3P, PH),
    ws, we (3P, PW): the windows of [box; box; outer box], and ex (3P, 4):
    each row's exclusion rectangle (h1, h2, w1, w2), none for the box rows,
    the inner box for the frame rows, the box for the context rows."""
    boxes = torch.where(valid[:, None], boxes, torch.zeros_like(boxes)).to(torch.float32)
    x1, y1, x2, y2 = boxes.unbind(1)
    ratio = torch.tensor(context_ratio, dtype=torch.float32, device=boxes.device)
    two = torch.tensor(2.0, dtype=torch.float32, device=boxes.device)
    rw, rh = x2 - x1, y2 - y1
    in_w, in_h = (rw - rw / ratio) / two, (rh - rh / ratio) / two
    out_w, out_h = (rw * ratio - rw) / two, (rh * ratio - rh) / two
    max_x, max_y = w / spatial_scale, h / spatial_scale
    inner = torch.stack([(x1 + in_w).clamp(0, max_x), (y1 + in_h).clamp(0, max_y),
                         (x2 - in_w).clamp(0, max_x), (y2 - in_h).clamp(0, max_y)], 1)
    outer = torch.stack([(x1 - out_w).clamp(0, max_x), (y1 - out_h).clamp(0, max_y),
                         (x2 + out_w).clamp(0, max_x), (y2 + out_h).clamp(0, max_y)], 1)

    def snap(b):   # (P, 4) XYXY -> (P, 4) int32 (h1, h2, w1, w2)
        r = torch.floor(b * spatial_scale + 0.5).to(torch.int32)
        return torch.stack([r[:, 1], r[:, 3], r[:, 0], r[:, 2]], 1)

    box_win = bin_windows(boxes, valid, h, w, ph_out, pw_out, spatial_scale)
    out_win = bin_windows(outer, valid, h, w, ph_out, pw_out, spatial_scale)
    hs, he, ws, we = (torch.cat([b, b, o]) for b, o in zip(box_win, out_win))
    ex = torch.cat([torch.zeros_like(snap(boxes)), snap(inner), snap(boxes)])
    return hs, he, ws, we, ex


def roi_loop_pool_reference(feat: torch.Tensor, hs, he, ws, we, ex, valid,
                            row_scale: Optional[torch.Tensor] = None):
    """Plain PyTorch ROILoopPool over precomputed windows: walks the window
    offsets (dy, dx) of the largest bin in h-major order and keeps, per (row,
    ph, pw, channel), the first kept cell strictly above the running maximum,
    which starts at 0 with pos -1. valid and row_scale are (P,) for the 3P
    rows. Returns (out (3P, PH, PW, C) feat.dtype, pos (3P, PH, PW, C)
    int32)."""
    h, w, c = feat.shape
    rows, ph = hs.shape
    pw = ws.shape[1]
    hs, he, ws, we, ex = (t.long() for t in (hs, he, ws, we, ex))
    best = torch.zeros((rows, ph, pw, c), dtype=feat.dtype, device=feat.device)
    pos = torch.full((rows, ph, pw, c), -1, dtype=torch.int32, device=feat.device)
    max_nh = int((he - hs).max()) if rows else 0
    max_nw = int((we - ws).max()) if rows else 0
    for dy in range(max_nh):
        y = hs + dy
        yc = y.clamp(0, h - 1)
        in_y = y < he
        cut_y = (y > ex[:, 0:1]) & (y < ex[:, 1:2])                   # (3P, PH)
        for dx in range(max_nw):
            x = ws + dx
            xc = x.clamp(0, w - 1)
            cut_x = (x > ex[:, 2:3]) & (x < ex[:, 3:4])               # (3P, PW)
            kept = (in_y[:, :, None] & (x < we)[:, None, :]
                    & ~(cut_y[:, :, None] & cut_x[:, None, :]))
            v = feat[yc[:, :, None], xc[:, None, :]]                  # (3P, PH, PW, C)
            take = kept[..., None] & (v > best)
            best = torch.where(take, v, best)
            flat = (yc * w)[:, :, None] + xc[:, None, :]
            pos = torch.where(take, flat[..., None].to(torch.int32), pos)
    out = best
    if row_scale is not None:
        out = out * row_scale.to(feat.dtype).repeat(3)[:, None, None, None]
    live = valid.repeat(3)[:, None, None, None]
    out = torch.where(live, out, torch.zeros((), dtype=out.dtype, device=out.device))
    pos = torch.where(live, pos, torch.full_like(pos, -1))
    return out, pos


def _loop_forward(feat, win, ex, valid, row_scale, return_argmax):
    if feat.is_cuda:
        return roi_loop_pool_fwd_cuda(feat, *win, ex, valid, row_scale,
                                      return_argmax=return_argmax)
    if feat.device.type == "cpu":
        return roi_loop_pool_reference(feat, *win, ex, valid, row_scale)
    raise ValueError(f"roi_loop_pool: no implementation for device {feat.device}")


class RoILoopPoolFunction(torch.autograd.Function):
    """ROILoopPool with the first-hit backward of ROIPool over the 3P rows;
    only ``feat`` gets a gradient."""

    @staticmethod
    def forward(ctx, feat, hs, he, ws, we, ex, valid, row_scale):
        out, pos = _loop_forward(feat, (hs, he, ws, we), ex, valid, row_scale, True)
        rs = None if row_scale is None else row_scale.to(feat.dtype).float().repeat(3)
        ctx.save_for_backward(pos, rs, hs, he, ws, we, valid.repeat(3))
        ctx.feat_shape, ctx.feat_dtype = feat.shape, feat.dtype
        ctx.mark_non_differentiable(pos)
        return out, pos

    @staticmethod
    def backward(ctx, g, _g_pos):
        pos, rs, *win = ctx.saved_tensors
        h, w, _ = ctx.feat_shape
        g = g.contiguous()
        if g.is_cuda:
            acc = roi_pool_bwd_cuda(g, pos, rs, *win, h, w)
        elif g.device.type == "cpu":
            acc = roi_pool_backward_reference(g, pos, rs, h, w)
        else:
            raise ValueError(f"roi_loop_pool backward: no implementation for device {g.device}")
        return acc.to(ctx.feat_dtype), None, None, None, None, None, None, None


def roi_loop_pool(feat_hwc: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                  row_scale: Optional[torch.Tensor] = None, *, spatial_scale: float,
                  output_size: Tuple[int, int] = (7, 7), context_ratio: float = CONTEXT_RATIO,
                  return_argmax: bool = False):
    """ROILoopPool of one (H, W, C) feature map into (3P, PH, PW, C) stacked
    [box; frame; context]. boxes (P, 4) XYXY image coords; valid (P,) bool;
    row_scale optional (P,) per-ROI scale applied to all three rows. A CPU
    ``feat_hwc`` runs the plain version; a CUDA one runs the hand-written
    kernel and raises if it cannot. When ``feat_hwc`` needs a gradient the
    pool is a ``RoILoopPoolFunction``. With ``return_argmax`` also returns
    the int32 first-hit positions."""
    h, w, _ = feat_hwc.shape
    ph_out, pw_out = output_size
    *win, ex = loop_windows(boxes, valid, h, w, ph_out, pw_out, spatial_scale, context_ratio)
    if feat_hwc.requires_grad and torch.is_grad_enabled():
        out, pos = RoILoopPoolFunction.apply(feat_hwc, *win, ex, valid, row_scale)
    else:
        out, pos = _loop_forward(feat_hwc, win, ex, valid, row_scale, return_argmax)
    return (out, pos) if return_argmax else out
