"""Deformable convolution (v1) and modulated deformable convolution (v2).

Counterpart of ``sos_wsod_tpu/ops/deform_conv.py`` (detectron2's DeformConv
and ModulatedDeformConv): for each output location p and kernel tap k,

    y[p, co] = sum_k sum_ci w[co, ci, k] * m_k(p) * x(p * stride + k * dilation
                                                    - pad + off_k(p))[ci]

with x sampled bilinearly at fractional positions (zeros outside the map).
The offsets are (dy, dx) interleaved per tap, channel 2k the row offset of
tap k and 2k + 1 its column offset: the JAX package's layout, not
detectron2's.

The JAX package's im2col form, in torch ops: the four bilinear corners of
every (location, tap) gathered at once from the channels-last map
(``index_select``, zeros outside), weighted and summed in the JAX order,
times the modulation, then one (Ho Wo, K Ci) x (K Ci, Co) product an
image. Autograd gives the backward; on the card the gather's backward
(``index_add_``) adds in an order that changes from run to run, so the
gradients of x repeat only to rounding there.
"""
from __future__ import annotations

from typing import Optional

import torch


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None, *,
                  stride: int = 1, padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """x (B, Ci, H, W); offset (B, 2K, Ho, Wo), (dy, dx) per tap; weight
    (Co, Ci, Kh, Kw), K = Kh Kw; mask (B, K, Ho, Wo) or None; bias (Co,) or
    None -> (B, Co, Ho, Wo) in x's dtype, Ho = (H + 2 pad - dilation (Kh - 1)
    - 1) // stride + 1."""
    bsz, ci, h, w = x.shape
    co, _, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    if offset.shape != (bsz, 2 * k, ho, wo):
        raise ValueError(f"deform_conv2d: offset {tuple(offset.shape)}, expected "
                         f"{(bsz, 2 * k, ho, wo)}")
    dev = x.device
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=torch.float32, device=dev) * dilation
    kx = torch.arange(kw, dtype=torch.float32, device=dev) * dilation
    base_y = oy[:, None, None] + ky.repeat_interleave(kw)[None, None, :]   # (Ho, 1, K)
    base_x = ox[None, :, None] + kx.repeat(kh)[None, None, :]              # (1, Wo, K)
    off = offset.float().permute(0, 2, 3, 1).reshape(bsz, ho, wo, k, 2)
    sy = base_y + off[..., 0]                                              # (B, Ho, Wo, K)
    sx = base_x + off[..., 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy1 = (sy - y0)[..., None]
    wx1 = (sx - x0)[..., None]
    flat = x.permute(0, 2, 3, 1).reshape(bsz * h * w, ci)
    first = (torch.arange(bsz, device=dev) * (h * w))[:, None, None, None]

    def corner(yc, xc):
        iy = yc.to(torch.int64)
        ix = xc.to(torch.int64)
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = torch.where(inside, first + iy * w + ix, torch.zeros_like(iy))
        vals = torch.index_select(flat, 0, idx.reshape(-1)).view(*idx.shape, ci)
        return torch.where(inside[..., None], vals, torch.zeros_like(vals))

    sampled = (corner(y0, x0) * (1 - wy1) * (1 - wx1) + corner(y0, x0 + 1) * (1 - wy1) * wx1
               + corner(y0 + 1, x0) * wy1 * (1 - wx1) + corner(y0 + 1, x0 + 1) * wy1 * wx1)
    if mask is not None:
        sampled = sampled * mask.permute(0, 2, 3, 1)[..., None]
    wmat = weight.permute(2, 3, 1, 0).reshape(k * ci, co)
    out = sampled.reshape(bsz, ho * wo, k * ci) @ wmat.to(sampled.dtype)
    if bias is not None:
        out = out + bias
    return out.view(bsz, ho, wo, co).permute(0, 3, 1, 2).to(x.dtype)
