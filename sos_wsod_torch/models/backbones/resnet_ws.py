"""WS-ResNet: the WSOD flavour of ResNet that the single-view model can take.

Counterpart of ``sos_wsod_tpu/models/backbones/resnet_ws.py`` (the
reference's build_ws_resnet_backbone):
  - a deep stem: three 3x3 convs (the first at stride 2), then a 2x2
    max pool at stride 2;
  - blocks never stride. The last block of res2 ends in a 2x2 max pool at
    stride 2; the last block of res3 in a 2x2 pool too, at stride 2 when
    res5_dilation is 1, else at stride 1 after an edge pad of one cell on
    the right and at the bottom, which keeps the size;
  - with res5_dilation 2, res4 and res5 are dilated by 2, so the trunk is
    stride 8 end to end, as the dilated VGG16 is; with 1 it is stride 16;
  - FrozenBN everywhere (``models/backbones/resnet.py``, its statistics
    are buffers).
``DeformBottleneckBlock`` is the same block with its 3x3 conv deformable
(``ops/deform_conv.py``); as in the JAX package, no config builds it
(``RESNETS.DEFORM_ON_PER_STAGE`` is read by no module).
The module names mirror the JAX parameter tree (``stem.conv1``,
``stem.conv1_norm`` ... ``res5_block2.shortcut_norm``), so a flax tree
converts leaf by leaf. cuDNN convs; run the model in
``torch.channels_last``.

``freeze_at`` freezes the stem (1) and the stages up to res{freeze_at}:
their parameters do not require grad, where the JAX package stops the
gradient after them. Their output is not detached: an input that takes no
gradient builds no graph through them anyway, and one that does (the CSC
head's CPG maps take the gradient of the class scores with respect to the
image) gets its gradient through them, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.deform_conv import deform_conv2d
from .resnet import DEPTH_BLOCKS, FrozenBN


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
          device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2), dilation=dilation,
                     bias=False, device=device)


class WSBasicStem(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64, device=None):
        super().__init__()
        for i, stride in enumerate((2, 1, 1), start=1):
            self.add_module(f"conv{i}", _conv(in_channels if i == 1 else out_channels,
                                              out_channels, 3, stride, device=device))
            self.add_module(f"conv{i}_norm", FrozenBN(out_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"conv{i}_norm")(getattr(self, f"conv{i}")(x)))
        return F.max_pool2d(x, 2, stride=2)


def _edge_pool(out: torch.Tensor, pool_stride: int) -> torch.Tensor:
    """The blocks' trailing 2x2 max pool: none for ``pool_stride`` 0; at
    stride 1 after an edge pad of one cell right and bottom, which keeps
    the size."""
    if pool_stride == 1:
        return F.max_pool2d(F.pad(out, (0, 1, 0, 1), mode="replicate"), 2, stride=1)
    if pool_stride:
        return F.max_pool2d(out, 2, stride=pool_stride)
    return out


class WSBottleneckBlock(nn.Module):
    """A bottleneck that never strides, with an optional trailing 2x2 max
    pool (``pool_stride`` 0: none)."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 dilation: int = 1, pool_stride: int = 0, device=None):
        super().__init__()
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, device=device)
        self.conv1_norm = FrozenBN(bottleneck_channels, device=device)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, dilation=dilation,
                           device=device)
        self.conv2_norm = FrozenBN(bottleneck_channels, device=device)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1, device=device)
        self.conv3_norm = FrozenBN(out_channels, device=device)
        self.has_shortcut = in_channels != out_channels
        if self.has_shortcut:
            self.shortcut = _conv(in_channels, out_channels, 1, device=device)
            self.shortcut_norm = FrozenBN(out_channels, device=device)
        self.pool_stride = pool_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1_norm(self.conv1(x)))
        out = F.relu(self.conv2_norm(self._conv2(out)))
        out = self.conv3_norm(self.conv3(out))
        sc = self.shortcut_norm(self.shortcut(x)) if self.has_shortcut else x
        return _edge_pool(F.relu(out + sc), self.pool_stride)

    def _conv2(self, out: torch.Tensor) -> torch.Tensor:
        return self.conv2(out)


class DeformBottleneckBlock(WSBottleneckBlock):
    """``WSBottleneckBlock`` with a (modulated) deformable 3x3 conv in place
    of conv2: the 3x3 ``conv2_offset`` (zero at init, so the block starts as
    a plain bottleneck) predicts 18 offset channels, or 27 when
    ``deform_modulated``: split [9, 9, 9], the first two nines stacked as
    (dy, dx) a tap, the sigmoid of the third the modulation.
    ``conv2_kernel`` (OIHW) is the deformable conv's weight, a parameter of
    the block as in the JAX tree."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 dilation: int = 1, deform_modulated: bool = False, pool_stride: int = 0,
                 device=None):
        super().__init__(in_channels, out_channels, bottleneck_channels, dilation, pool_stride,
                         device)
        del self.conv2
        self.conv2_offset = nn.Conv2d(bottleneck_channels, 27 if deform_modulated else 18, 3,
                                      padding=dilation, dilation=dilation, device=device)
        nn.init.zeros_(self.conv2_offset.weight)
        nn.init.zeros_(self.conv2_offset.bias)
        self.conv2_kernel = nn.Parameter(torch.empty(
            bottleneck_channels, bottleneck_channels, 3, 3, device=device))
        nn.init.kaiming_normal_(self.conv2_kernel, mode="fan_out", nonlinearity="relu")
        self.dilation = dilation
        self.deform_modulated = deform_modulated

    def _conv2(self, out: torch.Tensor) -> torch.Tensor:
        off = self.conv2_offset(out)
        if self.deform_modulated:
            o1, o2, m = off.split(9, dim=1)
            b, _, h, w = off.shape
            offset = torch.stack([o1, o2], dim=2).reshape(b, 18, h, w)
            mask = torch.sigmoid(m)
        else:
            offset, mask = off, None
        return deform_conv2d(out, offset, self.conv2_kernel, mask, stride=1,
                             padding=self.dilation, dilation=self.dilation)


class WSResNet(nn.Module):
    """Returns the requested stage outputs {"res2": ..., ...}, NCHW."""

    def __init__(self, depth: int = 50, freeze_at: int = 2,
                 out_features: Sequence[str] = ("res5",), res5_dilation: int = 2,
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 width_per_group: int = 64, device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stride = 8 if res5_dilation == 2 else 16
        self.stem = WSBasicStem(3, stem_out_channels, device=device)
        if freeze_at >= 1:
            self.stem.requires_grad_(False)
        self.stages = []   # (name, block names)
        in_ch, out_ch, bott_ch = stem_out_channels, res2_out_channels, width_per_group
        for stage, n_blocks in enumerate(DEPTH_BLOCKS[depth], start=2):
            dilation = res5_dilation if stage in (4, 5) else 1
            last_pool = {2: 2, 3: 2 if res5_dilation == 1 else 1}.get(stage, 0)
            names = []
            for b in range(n_blocks):
                name = f"res{stage}_block{b}"
                block = WSBottleneckBlock(in_ch if b == 0 else out_ch, out_ch, bott_ch,
                                          dilation=dilation,
                                          pool_stride=last_pool if b == n_blocks - 1 else 0,
                                          device=device)
                if freeze_at >= stage:
                    block.requires_grad_(False)
                self.add_module(name, block)
                names.append(name)
            self.stages.append((f"res{stage}", names))
            in_ch, out_ch, bott_ch = out_ch, out_ch * 2, bott_ch * 2
        self.out_channels = in_ch    # the last stage's

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {}
        for name, blocks in self.stages:
            for b in blocks:
                x = getattr(self, b)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs


def build_ws_resnet(cfg, out_features=None, device=None) -> WSResNet:
    r = cfg.MODEL.RESNETS
    return WSResNet(depth=r.DEPTH, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
                    out_features=tuple(out_features or r.OUT_FEATURES),
                    res5_dilation=r.RES5_DILATION, stem_out_channels=r.STEM_OUT_CHANNELS,
                    res2_out_channels=r.RES2_OUT_CHANNELS, width_per_group=r.WIDTH_PER_GROUP,
                    device=device)
