"""ResNet backbone (R-50/R-101, FrozenBN) for the stage-2/3 detector.

Counterpart of ``sos_wsod_tpu/models/backbones/resnet.py`` (detectron2
BasicStem, BottleneckBlock with stride_in_1x1, FrozenBN, freeze_at). The
module names mirror the JAX parameter tree (``stem.conv1``,
``stem.conv1_norm``, ``res2_block0.conv1`` ... ``res5_block2.shortcut_norm``),
so a flax tree converts leaf by leaf. cuDNN convs; run the model in
``torch.channels_last``, as the VGG16 backbone is.

FrozenBN keeps its four statistics as buffers: y = x * scale + shift with
scale = weight * rsqrt(running_var + eps) and shift = bias - running_mean *
scale, both cast to the input's dtype. Stages up to ``freeze_at`` take no
gradient (their parameters do not require grad and their output is
detached), where the JAX package stops the gradient.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
import torch.nn.functional as F


class FrozenBN(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[None, :, None, None] + shift.to(x.dtype)[None, :, None, None]


class BasicStem(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 7, stride=2, padding=3, bias=False,
                               device=device)
        self.conv1_norm = FrozenBN(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1_norm(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, stride_in_1x1: bool = True, dilation: int = 1, device=None):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(in_channels, bottleneck_channels, 1, stride=s1, bias=False,
                               device=device)
        self.conv1_norm = FrozenBN(bottleneck_channels, device=device)
        self.conv2 = nn.Conv2d(bottleneck_channels, bottleneck_channels, 3, stride=s3,
                               padding=dilation, dilation=dilation, bias=False, device=device)
        self.conv2_norm = FrozenBN(bottleneck_channels, device=device)
        self.conv3 = nn.Conv2d(bottleneck_channels, out_channels, 1, bias=False, device=device)
        self.conv3_norm = FrozenBN(out_channels, device=device)
        self.has_shortcut = in_channels != out_channels or stride != 1
        if self.has_shortcut:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False,
                                      device=device)
            self.shortcut_norm = FrozenBN(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1_norm(self.conv1(x)))
        out = F.relu(self.conv2_norm(self.conv2(out)))
        out = self.conv3_norm(self.conv3(out))
        sc = self.shortcut_norm(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(out + sc)


DEPTH_BLOCKS = {
    14: (1, 1, 1, 1),   # test-only mini depth, as in the JAX package
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class ResNet(nn.Module):
    """Returns the requested stage outputs {"res2": ..., ...}, NCHW."""

    def __init__(self, depth: int = 50, freeze_at: int = 2,
                 out_features: Sequence[str] = ("res4",), stride_in_1x1: bool = True,
                 res5_dilation: int = 1, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, width_per_group: int = 64, num_groups: int = 1,
                 device=None):
        super().__init__()
        if num_groups != 1:
            raise ValueError("group convs are not needed by the SoS configs")
        self.freeze_at = freeze_at
        self.out_features = tuple(out_features)
        self.stem = BasicStem(3, stem_out_channels, device=device)
        if freeze_at >= 1:
            self.stem.requires_grad_(False)
        self.stages = []   # (name, block names)
        in_ch, out_ch, bott_ch = stem_out_channels, res2_out_channels, width_per_group
        for stage, n_blocks in enumerate(DEPTH_BLOCKS[depth], start=2):
            first_stride, dilation = (1 if stage == 2 else 2), 1
            if stage == 5 and res5_dilation == 2:
                first_stride, dilation = 1, 2
            names = []
            for b in range(n_blocks):
                name = f"res{stage}_block{b}"
                block = BottleneckBlock(in_ch if b == 0 else out_ch, out_ch, bott_ch,
                                        stride=first_stride if b == 0 else 1,
                                        stride_in_1x1=stride_in_1x1, dilation=dilation,
                                        device=device)
                if freeze_at >= stage:
                    block.requires_grad_(False)
                self.add_module(name, block)
                names.append(name)
            self.stages.append((f"res{stage}", names))
            in_ch, out_ch, bott_ch = out_ch, out_ch * 2, bott_ch * 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outputs = {}
        for stage, (name, blocks) in enumerate(self.stages, start=2):
            for b in blocks:
                x = getattr(self, b)(x)
            if self.freeze_at >= stage:
                x = x.detach()
            if name in self.out_features:
                outputs[name] = x
        return outputs


def build_resnet(cfg, out_features=None, device=None) -> ResNet:
    r = cfg.MODEL.RESNETS
    return ResNet(depth=r.DEPTH, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
                  out_features=tuple(out_features or r.OUT_FEATURES),
                  stride_in_1x1=r.STRIDE_IN_1X1, res5_dilation=r.RES5_DILATION,
                  stem_out_channels=r.STEM_OUT_CHANNELS, res2_out_channels=r.RES2_OUT_CHANNELS,
                  width_per_group=r.WIDTH_PER_GROUP, num_groups=r.NUM_GROUPS, device=device)
