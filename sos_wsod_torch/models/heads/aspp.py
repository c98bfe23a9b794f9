"""The ASPP semantic-segmentation head of WSJDS and its losses.

Counterpart of ``sos_wsod_tpu/models/heads/aspp.py`` (the reference's
seg_heads.py ASPPHead):
  - ``ASPPBranch``: a 3x3 conv with dilation d (padding d), ReLU and dropout
    0.5, then a 1x1 conv, ReLU and dropout for each further entry of
    ``conv_dims``, then a 1x1 ``predictor``; every conv has a bias;
  - ``ASPPHead``: a 3x3 stride-1 max pool (padding 1, -inf outside, flax's
    "SAME"), then the branches of dilations 6, 12, 18 and 24, summed;
  - ``sem_seg_loss``: the per-class weighted BCE with logits, written as the
    JAX formula max(z, 0) - z t + log1p(exp(-|z|)) in f32, NaNs zeroed, sum;
  - ``seg_targets_from_cpg``: CPG maps -> {0, 1, ignore} targets with
    balancing weights 1/#pos and 1/#neg (ignore weight 0);
  - ``crf_constraint``: the dense CRF (``ops/dense_crf.py``, on the host) of
    [1 - max fg; fg] on the raw image, thresholded at 0.5 into balancing
    weights; no gradient;
  - ``constraint_loss``: KL(x_crf || sigmoid(x_sigmoid)) times the weights,
    entries above 1000 zeroed (the double sigmoid is the reference's).
Maps are channels-first here, (K, H, W), where the JAX functions take
(H, W, K). Modules and their parameters carry the flax tree's names
(``dilation6.conv1``, ``...predictor``), so ``engine/weights.py``
converts a JAX tree with no special case.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ...ops.dense_crf import dense_crf
from .dan import dropout

DILATIONS = (6, 12, 18, 24)


def _he_normal_(conv: nn.Conv2d) -> None:
    """flax's he_normal (fan_in, a normal truncated at 2 standard deviations
    and rescaled to keep the variance 2 / fan_in) and a zero bias."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std)
    nn.init.zeros_(conv.bias)


class ASPPBranch(nn.Module):
    def __init__(self, in_channels: int, dilation: int, conv_dims: Sequence[int] = (1024, 1024),
                 num_out: int = 20, dropout_rate: float = 0.5, device=None):
        super().__init__()
        dims = [in_channels, *conv_dims]
        for k in range(len(conv_dims)):
            d = dilation if k == 0 else 1
            self.add_module(f"conv{k + 1}", nn.Conv2d(
                dims[k], dims[k + 1], 3 if k == 0 else 1, padding=d if k == 0 else 0,
                dilation=d, device=device))
        self.predictor = nn.Conv2d(dims[-1], num_out, 1, device=device)
        self.num_convs = len(conv_dims)
        self.dropout_rate = dropout_rate
        if device is None or torch.device(device).type != "meta":
            for m in self.children():
                _he_normal_(m)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x: (N, C, H, W), contiguous -> (N, num_out, H, W) logits."""
        for k in range(self.num_convs):
            x = dropout(F.relu(_conv_nchw(getattr(self, f"conv{k + 1}"), x)), self.dropout_rate,
                        self.training, generator)
        return _conv_nchw(self.predictor, x)


def _conv_nchw(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on a contiguous NCHW ``x``, its weight made contiguous too
    (the model's weights are channels_last, ``engine/weights.py``); a 3x3
    conv of dilation d > 1 (padding d) as a plain 3x3 conv (padding 1) on
    the d x d sub-grids of ``x`` stacked as a batch (space to batch), the
    same sums. The whole head's forward at 88 x 120 x 512 in bf16 on an
    H100 (chip_smoke.py phase 17): 3.37 ms so, 13.18 ms with cuDNN's
    dilated convs in NCHW, 479 ms in channels_last."""
    w = conv.weight.contiguous()
    d = conv.dilation[0]
    if d == 1:
        return F.conv2d(x, w, conv.bias, conv.stride, conv.padding)
    n, c, h, wd = x.shape
    hb, wb = -(-h // d), -(-wd // d)
    xb = F.pad(x, (0, wb * d - wd, 0, hb * d - h)).reshape(n, c, hb, d, wb, d)
    xb = xb.permute(0, 3, 5, 1, 2, 4).reshape(n * d * d, c, hb, wb)
    yb = F.conv2d(xb, w, conv.bias, padding=1)
    y = yb.reshape(n, d, d, -1, hb, wb).permute(0, 3, 4, 1, 5, 2).reshape(n, -1, hb * d, wb * d)
    return y[:, :, :h, :wd].contiguous()


class ASPPHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 20,
                 conv_dims: Sequence[int] = (1024, 1024), mask_softmax: bool = False,
                 dilations: Sequence[int] = DILATIONS, dropout_rate: float = 0.5, device=None):
        super().__init__()
        self.mask_softmax = mask_softmax
        self.dilations = tuple(dilations)
        num_out = num_classes + 1 if mask_softmax else num_classes
        for d in self.dilations:
            self.add_module(f"dilation{d}", ASPPBranch(in_channels, d, conv_dims, num_out,
                                                       dropout_rate, device=device))

    def forward(self, features: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """features: (H, W, C) channels-last -> the summed branch logits
        (K[+1], H, W). Dropout draws from ``generator``, branch by branch."""
        x = F.max_pool2d(features.permute(2, 0, 1)[None], 3, stride=1, padding=1).contiguous()
        out = None
        for d in self.dilations:
            b = getattr(self, f"dilation{d}")(x, generator)
            out = b if out is None else out + b
        return out[0]


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(K, H, W) -> (K, h', w'), align_corners=False (``jax.image.resize``'s
    bilinear when it upsamples)."""
    return F.interpolate(x[None], size=tuple(size), mode="bilinear", align_corners=False)[0]


def sem_seg_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                 loss_weight: float = 1.0) -> torch.Tensor:
    """Per-class weighted BCE with logits, summed, NaNs zeroed. All (K, H, W)."""
    z = logits.float()
    t = targets.float()
    bce = z.clamp(min=0.0) - z * t + torch.log1p(torch.exp(-z.abs()))
    loss = bce * weights * loss_weight
    return torch.where(torch.isnan(loss), 0.0, loss).sum()


def _balance(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """1/#pos on the positives, 1/#neg on the negatives, 0 elsewhere (counts
    per class, floored at 1; divided tensor by tensor)."""
    one = torch.ones((), dtype=torch.float32, device=pos.device)
    npos = pos.sum(dim=(1, 2), keepdim=True).float().clamp(min=1.0)
    nneg = neg.sum(dim=(1, 2), keepdim=True).float().clamp(min=1.0)
    return torch.where(pos, one / npos, torch.where(neg, one / nneg, 0.0))


@torch.no_grad()
def seg_targets_from_cpg(cpgs: torch.Tensor, gt_classes_oh: torch.Tensor,
                         preds_img: torch.Tensor, *, tau: float = 0.7,
                         fg_threshold: float = 0.1, bg_threshold: float = 0.005
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cpgs (K, H, W) -> (targets, weights), both (K, H, W) f32, the ignored
    cells at target 0 and weight 0. The reference's order: a class whose
    image score is below ``tau`` is ignored over its CPG labels, and an
    absent class is negative everywhere, last."""
    cls_ignore = (preds_img < tau)[:, None, None]
    cls_neg = (gt_classes_oh == 0)[:, None, None]
    pos = (cpgs >= fg_threshold) & ~cls_ignore & ~cls_neg
    neg = ((cpgs < bg_threshold) & ~cls_ignore) | cls_neg
    return pos.float(), _balance(pos, neg)


def crf_constraint(image: torch.Tensor, x_sigmoid: torch.Tensor, *, fg_threshold: float = 0.5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (H, W, 3) raw BGR pixels, x_sigmoid (K, H, W) -> (x_crf_fg,
    weights), both (K, H, W) f32 on ``x_sigmoid``'s device, with no
    gradient. The dense CRF runs on the host on [1 - max fg; fg] and the
    image clipped to uint8; a cell is positive where the refined fg is at
    least ``fg_threshold``, and the weights are 1/#pos there, 1/#neg
    elsewhere (numpy, as the JAX host callback computes them)."""
    img = image.detach().float().cpu().numpy()
    fg = x_sigmoid.detach().float().cpu().numpy()
    bg = 1.0 - fg.max(axis=0, keepdims=True)
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    crf_fg = dense_crf(np.concatenate([bg, fg], axis=0), np.moveaxis(img_u8, -1, 0))[1:]
    pos = crf_fg >= fg_threshold
    neg = ~pos
    npos = pos.sum(axis=(1, 2), keepdims=True).astype(np.float32)
    nneg = neg.sum(axis=(1, 2), keepdims=True).astype(np.float32)
    weights = np.where(pos, 1.0 / np.maximum(npos, 1.0),
                       1.0 / np.maximum(nneg, 1.0)).astype(np.float32)
    device = x_sigmoid.device
    return (torch.from_numpy(crf_fg.astype(np.float32)).to(device),
            torch.from_numpy(weights).to(device))


def constraint_loss(x_sigmoid: torch.Tensor, x_crf: torch.Tensor,
                    weights_crf: torch.Tensor) -> torch.Tensor:
    """sum of KL(x_crf || sigmoid(x_sigmoid)) * weights, entries above 1000
    zeroed. All (K, H, W)."""
    logq = torch.log(torch.sigmoid(x_sigmoid.float()))
    p = x_crf.float()
    loss = p * (torch.log(p.clamp(min=1e-20)) - logq) * weights_crf
    return torch.where(loss > 1000.0, 0.0, loss).sum()
