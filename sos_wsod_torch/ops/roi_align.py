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
``roi_align_levels_backward_reference``. The plain backward fixes the order
and arithmetic that the kernel keeps: for each bin, the samples' factors
summed by row and by column, one term (g / count x Y) x X a cell, each
cell's terms added in f32 in (p, ph, pw) order; so the kernel's gradient is
the plain one's bit for bit, from run to run. The boxes get no gradient:
they come from detached proposals or from data.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..kernels.roi_align import roi_align_fwd_cuda
from ..kernels.roi_align_bwd import roi_align_bwd_cuda

TERM_CHUNK = 1 << 24     # elements of the plain backward's terms held at once


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


def _roi_geometry(shapes: Sequence[Tuple[int, int]], boxes: torch.Tensor,
                  valid: torch.Tensor, level: torch.Tensor, spatial_scales: Sequence[float],
                  output_size: Tuple[int, int], sampling_ratio: int, aligned: bool,
                  sample_cap: int) -> dict:
    """The plain version's per-ROI quantities: the level's map size ``h``,
    ``w`` (int32) and first row ``base`` of the flat map (all levels'
    (H_l * W_l) cells after one another, int64), the scaled box (P, 4),
    bin sizes, the grid ``grid_h``, ``grid_w`` (int32, fixed by
    sampling_ratio or ceil(bin) capped at the cap), the sample count (f32)
    and the cap."""
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
    return {"h": h, "w": w, "base": starts[lvl], "scaled": scaled, "bin_h": bin_h,
            "bin_w": bin_w, "grid_h": grid_h, "grid_w": grid_w, "count": count, "cap": cap}


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
    geo = _roi_geometry(shapes, boxes, valid, level, spatial_scales, output_size,
                        sampling_ratio, aligned, sample_cap)
    dev = boxes.device
    ph_out, pw_out = output_size
    p = boxes.shape[0]
    scaled, bin_h, bin_w = geo["scaled"], geo["bin_h"], geo["bin_w"]
    grid_h, grid_w = geo["grid_h"], geo["grid_w"]

    def samples():
        ph_idx = torch.arange(ph_out, dtype=torch.float32, device=dev)
        pw_idx = torch.arange(pw_out, dtype=torch.float32, device=dev)
        hh, ww = geo["h"][:, None, None], geo["w"][:, None, None]
        bb = geo["base"][:, None, None]
        gh, gw = grid_h.float(), grid_w.float()
        for iy in range(geo["cap"]):
            y_frac = torch.full_like(gh, iy + 0.5) / gh
            y = (scaled[:, 1][:, None] + ph_idx[None, :] * bin_h[:, None]
                 + y_frac[:, None] * bin_h[:, None])                      # (P, PH)
            y_ok = iy < grid_h
            for ix in range(geo["cap"]):
                x_frac = torch.full_like(gw, ix + 0.5) / gw
                x = (scaled[:, 0][:, None] + pw_idx[None, :] * bin_w[:, None]
                     + x_frac[:, None] * bin_w[:, None])                  # (P, PW)
                ok = (y_ok & (ix < grid_w)).float()
                yy = y[:, :, None].expand(p, ph_out, pw_out)
                xx = x[:, None, :].expand(p, ph_out, pw_out)
                idxs, wts = _bilinear_weights(yy, xx, hh, ww)
                yield [bb + ii for ii in idxs], wts, ok

    return geo["count"], samples()


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


def _axis_sums(start: torch.Tensor, bin_size: torch.Tensor, grid: torch.Tensor,
               n: torch.Tensor, bins: int, cap: int):
    """One axis of each bin's sample grid, folded into cells: the sample
    positions (start + b * bin) + ((i + 0.5) / grid) * bin of ROI p's bin b
    for i < grid, each giving two entries, (lo, factor h) then (hi, factor
    l), with the forward's clamps (factors +0 out of bounds). Returns, over
    the 2 * cap entries of each (P, bins): ``cells`` (int64), ``first``
    (bool: the entry is inside the grid and the first of its cell) and
    ``sums`` (f32: at a first entry, the sum from +0 of the factors of every
    entry of its cell, in entry order; +0 elsewhere)."""
    dev = start.device
    idx = torch.arange(bins, dtype=torch.float32, device=dev)
    nn = n[:, None]
    gf = grid.float()
    cells, facs, oks = [], [], []
    for i in range(cap):
        frac = torch.full_like(gf, i + 0.5) / gf
        v = start[:, None] + idx[None, :] * bin_size[:, None] + frac[:, None] * bin_size[:, None]
        oob = (v < -1.0) | (v > nn.float())
        v = v.clamp(min=0.0)
        lo = torch.minimum(v.to(torch.int32), nn - 1)
        hi = torch.minimum(lo + 1, nn - 1)
        v = torch.where(lo >= nn - 1, (nn - 1).float(), v)
        low = v - lo.float()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        ok = (i < grid)[:, None].expand_as(lo)
        cells += [lo, hi]
        facs += [torch.where(oob, zero, 1.0 - low), torch.where(oob, zero, low)]
        oks += [ok, ok]
    cells = torch.stack(cells, -1).long()
    facs, oks = torch.stack(facs, -1), torch.stack(oks, -1)
    e = cells.shape[-1]
    same = (cells[..., :, None] == cells[..., None, :]) & oks[..., :, None] & oks[..., None, :]
    rep = same.to(torch.uint8).argmax(-2)         # each entry's first entry of its cell
    first = oks & (rep == torch.arange(e, device=dev))
    sums = torch.zeros_like(facs)
    for k in range(e):
        at = rep[..., k:k + 1]
        add = torch.where(oks[..., k:k + 1], facs[..., k:k + 1], torch.zeros_like(facs[..., :1]))
        sums.scatter_(-1, at, sums.gather(-1, at) + add)
    return cells, first, sums


def backward_terms(shapes: Sequence[Tuple[int, int]], boxes: torch.Tensor, valid: torch.Tensor,
                   level: torch.Tensor, spatial_scales: Sequence[float], *,
                   output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                   aligned: bool = True, sample_cap: int = 8):
    """The plain backward's terms, one for each cell of each bin of each
    valid ROI, in (p, ph, pw, y, x) order: ``at`` (N, 5) int64, the indices
    (p, ph, pw, i, j) of the bin's row entry i and column entry j
    (``_axis_sums``); ``rows`` (N,) the cell's row of the flat map (all
    levels' (H_l * W_l) cells after one another); ``ysum``, ``xsum`` (N,)
    f32 the row's and the column's sums of factors; and ``count`` (P,) f32,
    each ROI's sample count."""
    ph_out, pw_out = output_size
    geo = _roi_geometry(shapes, boxes, valid, level, spatial_scales, output_size,
                        sampling_ratio, aligned, sample_cap)
    ycell, yfirst, ysum = _axis_sums(geo["scaled"][:, 1], geo["bin_h"], geo["grid_h"], geo["h"],
                                     ph_out, geo["cap"])
    xcell, xfirst, xsum = _axis_sums(geo["scaled"][:, 0], geo["bin_w"], geo["grid_w"], geo["w"],
                                     pw_out, geo["cap"])
    live = (valid[:, None, None, None, None] & yfirst[:, :, None, :, None]
            & xfirst[:, None, :, None, :])
    at = live.nonzero()
    p, ph, pw, i, j = at.unbind(1)
    rows = geo["base"][p] + ycell[p, ph, i] * geo["w"][p].long() + xcell[p, pw, j]
    return at, rows, ysum[p, ph, i], xsum[p, pw, j], geo["count"]


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
    default).

    The order and arithmetic that the backward kernel keeps: for each bin
    of each valid ROI, gc = g / count (a true division); Y[y], the sum from
    +0 of the factors of the bin's sample rows on row y (``_axis_sums``),
    and X[x] over the columns; one term (gc * Y[y]) * X[x] for each cell
    (y, x) the bin touches, each product rounded once; each cell's terms
    added from +0 into an f32 map in ascending (p, ph, pw) order
    (``index_add_`` on the CPU adds its rows in order), then rounded once
    to ``dtype``. This is the transpose of the forward, the function XLA's
    autodiff of the JAX roi_align computes, with the sample weights
    factored by rows and columns; invalid ROIs add nothing. The terms go in
    chunks of ``TERM_CHUNK`` elements."""
    c = grad.shape[1]
    at, rows, ysum, xsum, count = backward_terms(
        shapes, boxes, valid, level, spatial_scales, output_size=output_size,
        sampling_ratio=sampling_ratio, aligned=aligned, sample_cap=sample_cap)
    g = grad.permute(0, 2, 3, 1).float()
    gc = g / count[:, None, None, None]
    sizes = [h * w for h, w in shapes]
    total = torch.zeros((sum(sizes), c), dtype=torch.float32, device=grad.device)
    step = max(1, TERM_CHUNK // max(c, 1))
    for k in range(0, at.shape[0], step):
        p, ph, pw = at[k:k + step, :3].unbind(1)
        terms = gc[p, ph, pw] * ysum[k:k + step, None]
        total.index_add_(0, rows[k:k + step], terms * xsum[k:k + step, None])
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
