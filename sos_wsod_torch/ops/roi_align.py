"""ROIAlign (V1 / V2-aligned) over one or several feature levels.

Counterpart of ``roi_align`` in ``sos_wsod_tpu/ops/roi_align.py``
(detectron2's ROIAlign, ``aligned=True`` being "ROIAlignV2"). For
``sampling_ratio == 0`` each ROI's adaptive grid, ceil(bin size), is capped
at ``sample_cap`` = 8 samples a side, as in the JAX package; the reference's
grid is uncapped, so a bin wider than 8 cells is subsampled here.

``roi_align_levels`` pools each ROI from its own level of a feature pyramid
in one pass: the per-ROI level index picks the map, its size and its scale.
``roi_align`` is the one-level case. A CPU tensor takes the plain version,
``roi_align_levels_reference``, which follows the JAX loop order (sample row
``iy`` outer, column ``ix`` inner, the four corners in order,
``acc += sample * ok``, then one divide by the sample count) with every step
a separate torch op; a CUDA tensor launches the hand-written kernel
(``kernels/roi_align.py``), which does the same f32 operations in the same
order, or raises. Every division of the plain version is a true division of
two tensors, as the kernel's are.

The gradient with respect to the features comes from an autograd Function
(``_RoIAlignLevels``): on the card the backward kernel
(``kernels/roi_align_bwd.py``), on the CPU the plain backward,
``roi_align_levels_backward_reference``. Both put (g / count) x w_k onto
each sample's four corners, as XLA's autodiff of the JAX function does, and
sum in f32; the kernel sums with atomics, in a run-dependent order. The
boxes get no gradient: they come from detached proposals or from data.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..kernels.roi_align import roi_align_fwd_cuda
from ..kernels.roi_align_bwd import roi_align_bwd_cuda


def _bilinear_weights(y, x, h, w):
    """d2 bilinear with border snapping: y, x (...) f32 sample positions,
    h, w int32 map sizes broadcastable to them. Returns the 4 corner flat
    indices and weights, weights zero outside [-1, h] x [-1, w]."""
    oob = (y < -1.0) | (y > h.float()) | (x < -1.0) | (x > w.float())
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = torch.minimum(y.to(torch.int32), h - 1)
    x_low = torch.minimum(x.to(torch.int32), w - 1)
    y_high = torch.minimum(y_low + 1, h - 1)
    x_high = torch.minimum(x_low + 1, w - 1)
    y = torch.where(y_low >= h - 1, (h - 1).float(), y)
    x = torch.where(x_low >= w - 1, (w - 1).float(), x)
    ly = y - y_low.float()
    lx = x - x_low.float()
    hy, hx = 1.0 - ly, 1.0 - lx
    idx = [y_low * w + x_low, y_low * w + x_high, y_high * w + x_low, y_high * w + x_high]
    wts = [hy * hx, hy * lx, ly * hx, ly * lx]
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    return idx, [torch.where(oob, zero, wt) for wt in wts]


def _sample_geometry(shapes: Sequence[Tuple[int, int]], boxes: torch.Tensor,
                     valid: torch.Tensor, level: torch.Tensor, spatial_scales: Sequence[float],
                     output_size: Tuple[int, int], sampling_ratio: int, aligned: bool,
                     sample_cap: int):
    """The plain version's per-ROI geometry: each ROI's sample count (P,)
    f32 and, for each sample (iy, ix) of the cap x cap grid in the JAX loop
    order (iy outer, ix inner), the four corners' rows of the flat map (all
    levels' (H_l * W_l) cells after one another), as (P, PH, PW) int64, their
    weights (P, PH, PW) f32 and ``ok`` (P,) f32, 1 for the samples inside
    the ROI's grid. Returns (count, iterator)."""
    dev = boxes.device
    ph_out, pw_out = output_size
    cap = sampling_ratio if sampling_ratio > 0 else sample_cap
    p = boxes.shape[0]
    sizes = torch.tensor([h * w for h, w in shapes], dtype=torch.int64)
    starts = (torch.cumsum(sizes, 0) - sizes).to(dev)
    lvl = level.long()
    h = torch.tensor([s[0] for s in shapes], dtype=torch.int32, device=dev)[lvl]
    w = torch.tensor([s[1] for s in shapes], dtype=torch.int32, device=dev)[lvl]
    scale = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)[lvl]
    base = starts[lvl]

    boxes = torch.where(valid[:, None], boxes, torch.zeros_like(boxes)).float()
    offset = 0.5 if aligned else 0.0
    scaled = boxes * scale[:, None] - offset
    roi_w = scaled[:, 2] - scaled[:, 0]
    roi_h = scaled[:, 3] - scaled[:, 1]
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    # true divisions of two tensors: torch computes a tensor divided by a
    # Python number on the card, and a number divided by a tensor anywhere,
    # as a product with the reciprocal, which rounds differently
    bin_h = roi_h / torch.full_like(roi_h, ph_out)
    bin_w = roi_w / torch.full_like(roi_w, pw_out)
    if sampling_ratio > 0:
        grid_h = torch.full((p,), sampling_ratio, dtype=torch.int32, device=dev)
        grid_w = grid_h
    else:
        grid_h = torch.ceil(bin_h).to(torch.int32).clamp(1, cap)
        grid_w = torch.ceil(bin_w).to(torch.int32).clamp(1, cap)
    count = torch.clamp(grid_h * grid_w, min=1).float()

    def samples():
        ph_idx = torch.arange(ph_out, dtype=torch.float32, device=dev)
        pw_idx = torch.arange(pw_out, dtype=torch.float32, device=dev)
        hh, ww, bb = h[:, None, None], w[:, None, None], base[:, None, None]
        gh, gw = grid_h.float(), grid_w.float()
        for iy in range(cap):
            y_frac = torch.full_like(gh, iy + 0.5) / gh
            y = (scaled[:, 1][:, None] + ph_idx[None, :] * bin_h[:, None]
                 + y_frac[:, None] * bin_h[:, None])                      # (P, PH)
            y_ok = iy < grid_h
            for ix in range(cap):
                x_frac = torch.full_like(gw, ix + 0.5) / gw
                x = (scaled[:, 0][:, None] + pw_idx[None, :] * bin_w[:, None]
                     + x_frac[:, None] * bin_w[:, None])                  # (P, PW)
                ok = (y_ok & (ix < grid_w)).float()
                yy = y[:, :, None].expand(p, ph_out, pw_out)
                xx = x[:, None, :].expand(p, ph_out, pw_out)
                idxs, wts = _bilinear_weights(yy, xx, hh, ww)
                yield [bb + ii for ii in idxs], wts, ok

    return count, samples()


def roi_align_levels_reference(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                               valid: torch.Tensor, level: torch.Tensor,
                               spatial_scales: Sequence[float], *,
                               output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                               aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """The plain version. features: per level (H_l, W_l, C); boxes (P, 4)
    XYXY; valid (P,); level (P,) int, the level each ROI pools from ->
    (P, C, PH, PW) in the features' dtype, zeros for invalid ROIs."""
    ph_out, pw_out = output_size
    c = features[0].shape[-1]
    p = boxes.shape[0]
    flat = torch.cat([f.reshape(-1, c) for f in features])
    count, samples = _sample_geometry([tuple(f.shape[:2]) for f in features], boxes, valid,
                                      level, spatial_scales, output_size, sampling_ratio,
                                      aligned, sample_cap)
    acc = torch.zeros((p, ph_out, pw_out, c), dtype=torch.float32, device=boxes.device)
    for idxs, wts, ok in samples:
        sample = torch.zeros_like(acc)
        for ii, wt in zip(idxs, wts):
            rows = flat[ii.reshape(-1)].reshape(p, ph_out, pw_out, c)
            sample = sample + rows * wt[..., None]
        acc = acc + sample * ok[:, None, None, None]
    out = acc / count[:, None, None, None]
    out = torch.where(valid[:, None, None, None], out, torch.zeros_like(out))
    return out.to(features[0].dtype).permute(0, 3, 1, 2)


def roi_align_levels_backward_reference(grad: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                                        boxes: torch.Tensor, valid: torch.Tensor,
                                        level: torch.Tensor, spatial_scales: Sequence[float], *,
                                        output_size: Tuple[int, int] = (7, 7),
                                        sampling_ratio: int = 0, aligned: bool = True,
                                        sample_cap: int = 8, dtype: torch.dtype = None
                                        ) -> List[torch.Tensor]:
    """The plain backward: grad (P, C, PH, PW), the gradient of
    ``roi_align_levels_reference``'s output; shapes (H_l, W_l) of each
    level -> each level's (H_l, W_l, C) gradient in ``dtype`` (grad's by
    default). The transpose of the forward, in the order XLA's autodiff of
    the JAX function takes it: g masked to the valid ROIs, divided by the
    sample count, times ``ok``, times each corner's weight, then added into
    an f32 map with ``index_add_``, one sample and corner at a time, and
    rounded once to ``dtype``."""
    c = grad.shape[1]
    count, samples = _sample_geometry(shapes, boxes, valid, level, spatial_scales, output_size,
                                      sampling_ratio, aligned, sample_cap)
    g = grad.permute(0, 2, 3, 1).float()
    g = torch.where(valid[:, None, None, None], g, torch.zeros_like(g))
    gc = g / count[:, None, None, None]
    sizes = [h * w for h, w in shapes]
    total = torch.zeros((sum(sizes), c), dtype=torch.float32, device=grad.device)
    for idxs, wts, ok in samples:
        d_sample = gc * ok[:, None, None, None]
        for ii, wt in zip(idxs, wts):
            total.index_add_(0, ii.reshape(-1), (d_sample * wt[..., None]).reshape(-1, c))
    total = total.to(dtype or grad.dtype)
    return [t.view(h, w, c) for t, (h, w) in zip(total.split(sizes), shapes)]


class _RoIAlignLevels(torch.autograd.Function):
    """``roi_align_levels`` with a gradient for the features: the forward
    kernel and the backward kernel on the card, the plain versions on the
    CPU. Returns (P, PH, PW, C)."""

    @staticmethod
    def forward(ctx, boxes, valid, level, spatial_scales, kw, *features):
        ctx.save_for_backward(boxes, valid, level)
        ctx.spatial_scales, ctx.kw = spatial_scales, kw
        ctx.shapes = [tuple(f.shape[:2]) for f in features]
        ctx.dtype = features[0].dtype
        if features[0].is_cuda:
            return roi_align_fwd_cuda(list(features), boxes, valid, level, spatial_scales, **kw)
        return roi_align_levels_reference(features, boxes, valid, level, spatial_scales,
                                          **kw).permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, grad):
        boxes, valid, level = ctx.saved_tensors
        if grad.is_cuda:
            kw = {k: v for k, v in ctx.kw.items() if k != "output_size"}
            grads = roi_align_bwd_cuda(grad.to(ctx.dtype).contiguous(), ctx.shapes, boxes, valid,
                                       level, ctx.spatial_scales, **kw)
        else:
            grads = roi_align_levels_backward_reference(
                grad.permute(0, 3, 1, 2), ctx.shapes, boxes, valid, level, ctx.spatial_scales,
                dtype=ctx.dtype, **ctx.kw)
        return (None,) * 5 + tuple(grads)


def roi_align_levels(features: Sequence[torch.Tensor], boxes: torch.Tensor, valid: torch.Tensor,
                     level: torch.Tensor, spatial_scales: Sequence[float], *,
                     output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                     aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """features: per level (H_l, W_l, C); boxes (P, 4); valid (P,); level
    (P,) int in [0, len(features)) -> (P, C, PH, PW) in the features' dtype.
    On the card the result is a (P, C, PH, PW) view of a (P, PH, PW, C)
    tensor, the layout the box head flattens. Where a feature map requires
    grad, the features get one (the boxes do not)."""
    kw = dict(output_size=tuple(output_size), sampling_ratio=sampling_ratio, aligned=aligned,
              sample_cap=sample_cap)
    dev = features[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"roi_align: no implementation for device {dev}")
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        out = _RoIAlignLevels.apply(boxes.detach().float().contiguous(), valid.contiguous(),
                                    level.to(torch.int32).contiguous(), tuple(spatial_scales),
                                    kw, *[f.contiguous() for f in features])
        return out.permute(0, 3, 1, 2)
    if features[0].is_cuda:
        out = roi_align_fwd_cuda([f.contiguous() for f in features],
                                 boxes.float().contiguous(), valid.contiguous(),
                                 level.to(torch.int32).contiguous(), spatial_scales, **kw)
        return out.permute(0, 3, 1, 2)
    return roi_align_levels_reference(features, boxes, valid, level, spatial_scales, **kw)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor, *,
              spatial_scale: float, output_size: Tuple[int, int] = (7, 7),
              sampling_ratio: int = 0, aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """feat (H, W, C), boxes (P, 4) XYXY, valid (P,) -> (P, C, PH, PW)."""
    level = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    return roi_align_levels([feat], boxes, valid, level, (spatial_scale,),
                            output_size=output_size, sampling_ratio=sampling_ratio,
                            aligned=aligned, sample_cap=sample_cap)
