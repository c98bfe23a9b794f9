"""VGG16 backbone (WSOD flavour): 5 plain conv stages, dilated conv5.

Counterpart of ``sos_wsod_tpu/models/backbones/vgg.py``:
  plain1: 2 convs 3x3/64,  maxpool 2x2 s2        -> stride 2
  plain2: 2 convs 3x3/128, maxpool 2x2 s2        -> stride 4
  plain3: 3 convs 3x3/256, maxpool 2x2 s2        -> stride 8
  plain4: 3 convs 3x3/512, maxpool 2x2 s1 when conv5_dilation==2 (stride stays 8)
  plain5: 3 convs 3x3/512 dilation=2, no pool    -> 'plain5', 512ch, stride 8
Features beyond each stage's valid extent are zeroed, so a padded canvas gives
the features of the unpadded image up to the convs' zero-padding convention.
Run in ``torch.channels_last``: then ``plain5.permute(0, 2, 3, 1)`` is already
a contiguous NHWC tensor.

``freeze_at=2`` freezes plain1 and plain2: their parameters do not require
grad (the JAX package gives them lr 0 and weight decay 0, and stops the
gradient after plain{freeze_at}). Their output is not detached: an input
that takes no gradient builds no graph through them anyway, and one that
does (the CSC head's CPG maps take the gradient of the class scores with
respect to the image) gets its gradient through them, as in the reference,
where the JAX package's stop_gradient leaves every CPG map zero.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


class PlainStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_conv: int,
                 dilation: int = 1, pool_stride: int = 0, device=None):
        super().__init__()
        self.pool_stride = pool_stride  # 0 = no pool; else 2x2 maxpool, this stride
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", nn.Conv2d(
                in_channels if i == 0 else out_channels, out_channels, 3,
                padding=dilation, dilation=dilation, device=device))
        self.num_conv = num_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        if self.pool_stride:
            x = F.max_pool2d(x, 2, stride=self.pool_stride)
        return x


def _stage_valid(valid_hw: torch.Tensor, pool_stride: int) -> torch.Tensor:
    """Valid extent after a stage: convs keep the size; a 2x2 pool maps
    H -> floor((H-2)/s)+1, on the canvas and on its valid region alike."""
    if pool_stride:
        return torch.clamp(torch.div(valid_hw - 2, pool_stride, rounding_mode="floor") + 1,
                           min=1)
    return valid_hw


def _mask_padding(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """Zero NCHW features at/beyond the valid (h, w) extent; valid_hw (N, 2)."""
    _, _, h, w = x.shape
    rows = torch.arange(h, device=x.device)[None, :, None] < valid_hw[:, 0, None, None]
    cols = torch.arange(w, device=x.device)[None, None, :] < valid_hw[:, 1, None, None]
    return x * (rows & cols)[:, None].to(x.dtype)


class VGG16(nn.Module):
    """Returns the 'plain5' feature map, NCHW shape in channels_last memory."""

    out_channels = 512

    def __init__(self, conv5_dilation: int = 2, freeze_at: int = 2, device=None):
        super().__init__()
        p4_pool = 1 if conv5_dilation == 2 else 2
        spec = [  # (name, in, out, num_conv, dilation, pool)
            ("plain1", 3, 64, 2, 1, 2),
            ("plain2", 64, 128, 2, 1, 2),
            ("plain3", 128, 256, 3, 1, 2),
            ("plain4", 256, 512, 3, 1, p4_pool),
            ("plain5", 512, 512, 3, conv5_dilation, 0),
        ]
        self.stage_names = [s[0] for s in spec]
        for name, cin, cout, n, dil, pool in spec:
            self.add_module(name, PlainStage(cin, cout, n, dil, pool, device=device))
        for name in self.stage_names[:freeze_at]:
            getattr(self, name).requires_grad_(False)

    def forward(self, x: torch.Tensor, valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, 3, H, W) BGR mean-subtracted; valid_hw: (N, 2) true extents."""
        v = valid_hw
        for name in self.stage_names:
            stage = getattr(self, name)
            x = stage(x)
            if v is not None:
                v = _stage_valid(v, stage.pool_stride)
                x = _mask_padding(x, v)
        return x
