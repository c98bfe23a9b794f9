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
two tensors, as the kernel's are. The kernel is forward only: a CUDA feature
map that requires grad raises.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..kernels.roi_align import roi_align_fwd_cuda


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


def roi_align_levels_reference(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                               valid: torch.Tensor, level: torch.Tensor,
                               spatial_scales: Sequence[float], *,
                               output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                               aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """The plain version. features: per level (H_l, W_l, C); boxes (P, 4)
    XYXY; valid (P,); level (P,) int, the level each ROI pools from ->
    (P, C, PH, PW) in the features' dtype, zeros for invalid ROIs."""
    dev = boxes.device
    ph_out, pw_out = output_size
    cap = sampling_ratio if sampling_ratio > 0 else sample_cap
    c = features[0].shape[-1]
    p = boxes.shape[0]
    flat = torch.cat([f.reshape(-1, c) for f in features])
    sizes = torch.tensor([f.shape[0] * f.shape[1] for f in features], dtype=torch.int64)
    starts = (torch.cumsum(sizes, 0) - sizes).to(dev)
    lvl = level.long()
    h = torch.tensor([f.shape[0] for f in features], dtype=torch.int32, device=dev)[lvl]
    w = torch.tensor([f.shape[1] for f in features], dtype=torch.int32, device=dev)[lvl]
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

    ph_idx = torch.arange(ph_out, dtype=torch.float32, device=dev)
    pw_idx = torch.arange(pw_out, dtype=torch.float32, device=dev)
    hh, ww, bb = h[:, None, None], w[:, None, None], base[:, None, None]
    gh, gw = grid_h.float(), grid_w.float()
    acc = torch.zeros((p, ph_out, pw_out, c), dtype=torch.float32, device=dev)
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
            sample = torch.zeros_like(acc)
            for ii, wt in zip(idxs, wts):
                rows = flat[(bb + ii).reshape(-1)].reshape(p, ph_out, pw_out, c)
                sample = sample + rows * wt[..., None]
            acc = acc + sample * ok[:, None, None, None]
    out = acc / count[:, None, None, None]
    out = torch.where(valid[:, None, None, None], out, torch.zeros_like(out))
    return out.to(features[0].dtype).permute(0, 3, 1, 2)


def roi_align_levels(features: Sequence[torch.Tensor], boxes: torch.Tensor, valid: torch.Tensor,
                     level: torch.Tensor, spatial_scales: Sequence[float], *,
                     output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                     aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """features: per level (H_l, W_l, C); boxes (P, 4); valid (P,); level
    (P,) int in [0, len(features)) -> (P, C, PH, PW) in the features' dtype.
    On the card the result is a (P, C, PH, PW) view of a (P, PH, PW, C)
    tensor, the layout the box head flattens."""
    kw = dict(output_size=tuple(output_size), sampling_ratio=sampling_ratio, aligned=aligned,
              sample_cap=sample_cap)
    if features[0].is_cuda:
        if torch.is_grad_enabled() and any(f.requires_grad for f in features):
            raise NotImplementedError(
                "roi_align: the CUDA kernel is forward only; its backward comes with the "
                "stage-2/3 training slice (ROADMAP Queue 1 item 4)")
        out = roi_align_fwd_cuda([f.contiguous() for f in features],
                                 boxes.float().contiguous(), valid.contiguous(),
                                 level.to(torch.int32).contiguous(), spatial_scales, **kw)
        return out.permute(0, 3, 1, 2)
    if features[0].device.type == "cpu":
        return roi_align_levels_reference(features, boxes, valid, level, spatial_scales, **kw)
    raise ValueError(f"roi_align: no implementation for device {features[0].device}")


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor, *,
              spatial_scale: float, output_size: Tuple[int, int] = (7, 7),
              sampling_ratio: int = 0, aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """feat (H, W, C), boxes (P, 4) XYXY, valid (P,) -> (P, C, PH, PW)."""
    level = torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device)
    return roi_align_levels([feat], boxes, valid, level, (spatial_scale,),
                            output_size=output_size, sampling_ratio=sampling_ratio,
                            aligned=aligned, sample_cap=sample_cap)
