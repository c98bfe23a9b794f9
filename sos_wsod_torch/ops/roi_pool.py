"""ROI max pooling with torchvision RoIPool semantics, channels-last.

Counterpart of ``sos_wsod_tpu/ops/roi_pool.py`` (the window math and the
argmax-key path) and of the Pallas kernel
``sos_wsod_tpu/ops/pallas/roi_pool_fused.py``. Semantics:

    rs = floor(coord * spatial_scale + 0.5)               (round half up)
    roi_w = max(re_w - rs_w + 1, 1)
    wstart = clamp(floor(pw * roi_w / PW) + rs_w, 0, W)
    wend   = clamp(ceil((pw+1) * roi_w / PW) + rs_w, 0, W)
    out[p, ph, pw, c] = max over the [hstart,hend) x [wstart,wend) window,
                        times row_scale[p] cast to the feature dtype;
                        0 where the window is empty or the slot is invalid.
    pos[p, ph, pw, c] = flat y*W+x of the first maximum in an h-major scan
                        (the smallest flat position among ties), -1 where
                        out is forced to 0.

``bin_windows`` computes the integer bin bounds once; the plain version here
and the CUDA kernel (``kernels/roi_pool.py``) both consume them.

Backward (the VJP of ``roi_pool_fused``): the cotangent times the row scale,
rounded to the feature dtype and widened to f32, is scattered to ``pos`` in
an f32 (H, W, C) accumulator and cast to the feature dtype. Ties therefore
route to the first hit. ``boxes``, ``valid`` and ``row_scale`` get no
gradient: objectness is input data. ``RoIPoolFunction`` saves the forward's
``pos`` (4096 x 49 x 512 int32 = 411 MB a view at full width) instead of
re-running the forward as the JAX VJP does, and the bin windows and ``valid``
(0.5 MB) that the CUDA backward uses to find each output tile's bins.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.roi_pool import roi_pool_fwd_cuda
from ..kernels.roi_pool_bwd import roi_pool_bwd_cuda


def _bin_bounds(start: torch.Tensor, size: torch.Tensor, pooled: int, limit: int):
    """Integer bin boundaries for one spatial dim: start, size (P,) int32 ->
    s, e (P, pooled), floor(g*size/pooled) / ceil((g+1)*size/pooled) in exact
    integer arithmetic, offset by start and clipped to [0, limit]."""
    grid = torch.arange(pooled, dtype=torch.int32, device=start.device)
    lo = torch.div(grid[None, :] * size[:, None], pooled, rounding_mode="floor")
    hi = torch.div((grid[None, :] + 1) * size[:, None] + (pooled - 1), pooled,
                   rounding_mode="floor")
    s = (lo + start[:, None]).clamp(0, limit)
    e = (hi + start[:, None]).clamp(0, limit)
    return s.to(torch.int32), e.to(torch.int32)


def bin_windows(boxes: torch.Tensor, valid: torch.Tensor, h: int, w: int,
                ph_out: int, pw_out: int, spatial_scale: float):
    """ROI -> per-bin half-open window bounds clipped to the feature extent.

    boxes (P, 4) XYXY image coords; valid (P,) bool. Returns int32
    hs, he (P, PH) and ws, we (P, PW). Invalid slots are computed from a zero
    box (the caller masks their output)."""
    boxes = torch.where(valid[:, None], boxes, torch.zeros_like(boxes))
    scaled = boxes.to(torch.float32) * spatial_scale
    r = torch.floor(scaled + 0.5).to(torch.int32)
    # clamp overhang to one bin's worth past the extent
    rs_w = r[:, 0].clamp(0, w + pw_out)
    rs_h = r[:, 1].clamp(0, h + ph_out)
    re_w = r[:, 2].clamp(-1, w + pw_out)
    re_h = r[:, 3].clamp(-1, h + ph_out)
    roi_w = (re_w - rs_w + 1).clamp(min=1)
    roi_h = (re_h - rs_h + 1).clamp(min=1)
    hs, he = _bin_bounds(rs_h, roi_h, ph_out, h)
    ws, we = _bin_bounds(rs_w, roi_w, pw_out, w)
    return hs, he, ws, we


def roi_pool_reference(feat: torch.Tensor, hs, he, ws, we, valid,
                       row_scale: Optional[torch.Tensor] = None):
    """Plain PyTorch ROIPool over precomputed bin windows.

    Walks the window offsets (dy, dx) of the largest bin in h-major order and
    keeps, per (roi, ph, pw, channel), the first strictly larger value — the
    same scan order as the kernel, written as whole-tensor gathers. Returns
    (out (P, PH, PW, C) feat.dtype, pos (P, PH, PW, C) int32)."""
    h, w, c = feat.shape
    p, ph = hs.shape
    pw = ws.shape[1]
    hs, he, ws, we = (t.long() for t in (hs, he, ws, we))
    best = torch.full((p, ph, pw, c), float("-inf"), dtype=feat.dtype,
                      device=feat.device)
    pos = torch.full((p, ph, pw, c), -1, dtype=torch.int32, device=feat.device)
    max_nh = int((he - hs).max()) if p else 0
    max_nw = int((we - ws).max()) if p else 0
    for dy in range(max_nh):
        y = hs + dy
        yc = y.clamp(0, h - 1)
        in_y = y < he
        for dx in range(max_nw):
            x = ws + dx
            xc = x.clamp(0, w - 1)
            inside = (in_y[:, :, None] & (x < we)[:, None, :])[..., None]
            v = feat[yc[:, :, None], xc[:, None, :]]          # (P, PH, PW, C)
            take = inside & ((v > best) | (pos < 0))
            best = torch.where(take, v, best)
            flat = (yc * w)[:, :, None] + xc[:, None, :]      # (P, PH, PW)
            pos = torch.where(take, flat[..., None].to(torch.int32), pos)
    out = best
    if row_scale is not None:
        out = out * row_scale.to(feat.dtype)[:, None, None, None]
    # the window is non-empty and the slot is valid
    live = ((he > hs)[:, :, None] & (we > ws)[:, None, :] & valid[:, None, None])[..., None]
    out = torch.where(live, out, torch.zeros((), dtype=out.dtype, device=out.device))
    pos = torch.where(live, pos, torch.full_like(pos, -1))
    return out, pos


def roi_pool_backward_reference(g: torch.Tensor, pos: torch.Tensor,
                                rs: Optional[torch.Tensor], h: int, w: int) -> torch.Tensor:
    """Plain PyTorch ROIPool backward: g (P, PH, PW, C) times rs (P,) (or
    no scale), added at pos (P, PH, PW, C) int32 into a zeroed f32 (h, w, C)
    accumulator; entries with pos < 0 add nothing. Returns the accumulator."""
    c = g.shape[-1]
    gp = g.float()
    if rs is not None:
        gp = gp * rs[:, None, None, None]
    ch = torch.arange(c, dtype=torch.int64, device=g.device)
    flat = torch.where(pos >= 0, pos.long() * c + ch, h * w * c)   # a trash slot at the end
    acc = torch.zeros(h * w * c + 1, dtype=torch.float32, device=g.device)
    acc.index_add_(0, flat.reshape(-1), gp.reshape(-1))
    return acc[:-1].reshape(h, w, c)


def _pool_forward(feat, win, valid, row_scale, return_argmax):
    if feat.is_cuda:
        return roi_pool_fwd_cuda(feat, *win, valid, row_scale, return_argmax=return_argmax)
    if feat.device.type == "cpu":
        return roi_pool_reference(feat, *win, valid, row_scale)
    raise ValueError(f"roi_pool: no implementation for device {feat.device}")


class RoIPoolFunction(torch.autograd.Function):
    """ROIPool with the first-hit backward; only ``feat`` gets a gradient."""

    @staticmethod
    def forward(ctx, feat, hs, he, ws, we, valid, row_scale):
        out, pos = _pool_forward(feat, (hs, he, ws, we), valid, row_scale, True)
        rs = None if row_scale is None else row_scale.to(feat.dtype).float()
        ctx.save_for_backward(pos, rs, hs, he, ws, we, valid)
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
            raise ValueError(f"roi_pool backward: no implementation for device {g.device}")
        return acc.to(ctx.feat_dtype), None, None, None, None, None, None


def roi_pool(feat_hwc: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
             row_scale: Optional[torch.Tensor] = None, *,
             spatial_scale: float,
             output_size: Tuple[int, int] = (7, 7),
             return_argmax: bool = False):
    """ROI max pool of one (H, W, C) feature map into (P, PH, PW, C).

    boxes (P, 4) XYXY image coords; valid (P,) bool; row_scale optional (P,)
    per-ROI scale (the objectness weighting), cast to the feature dtype before
    the multiply. A CPU ``feat_hwc`` runs the plain versions; a CUDA one runs
    the hand-written kernels and raises if it cannot. When ``feat_hwc``
    needs a gradient the pool is a ``RoIPoolFunction`` (forward and backward
    kernels). With ``return_argmax`` also returns the int32 first-hit
    positions."""
    h, w, _ = feat_hwc.shape
    ph_out, pw_out = output_size
    win = bin_windows(boxes, valid, h, w, ph_out, pw_out, spatial_scale)
    if feat_hwc.requires_grad and torch.is_grad_enabled():
        out, pos = RoIPoolFunction.apply(feat_hwc, *win, valid, row_scale)
    else:
        out, pos = _pool_forward(feat_hwc, win, valid, row_scale, return_argmax)
    return (out, pos) if return_argmax else out
