"""MRRP: the multi-rate receptive-field pyramid VGG16 of UWSOD.

Counterpart of ``sos_wsod_tpu/models/backbones/mrrp.py`` (the reference's
mrrp_conv.py and vgg_mrrp.py):
  - ``MRRPConv``: ONE weight and one bias applied to each branch i of a
    (B, C, H, W) batch of branches at dilation ``dilations[i]`` with padding
    d * (k // 2), so each branch keeps its size;
  - ``MRRPPlainStage``: ``num_conv`` x (MRRPConv + ReLU), optional 2x2 pool;
  - ``MRRPVGG16``: plain1-plain4 as ``vgg.PlainStage`` (plain4's 2x2 pool at
    stride 1: stride 8), then plain5, the MRRP stage, fed the same stage-4
    map on every branch (a stride-0 view, no copy). It returns
    (B, 512, H/8, W/8), branch b at dilation ``branch_dilations[b]``.
Like the JAX ``MRRPVGG16``, it takes no valid extent and masks no padding.
Frozen stages (``freeze_at``) take no gradient by ``requires_grad``, as in
``vgg.VGG16``.

A branch's conv runs as ``branch_conv``: cuDNN's dilated conv on the
channels_last tensors the model holds (``engine/weights.py``). The stage on
three branches of 87 x 119 x 512 in bf16 on an H100 at 700 W (chip_smoke.py
phase 18, two runs), forward / forward + backward: 1.28-1.43 / 5.28-5.58 ms
so, 1.79-1.84 / 5.21-6.56 in NCHW, 2.28-3.95 / 7.03-9.41 as plain convs on
the d x d sub-grids (``heads/aspp.py``'s form, which the ASPP's dilations of
6 to 24 need, and which small dilations do not repay).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .vgg import PlainStage


def branch_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                dilation: int, padding: int) -> torch.Tensor:
    """One branch's conv, (N, C, H, W) -> (N, O, H, W)."""
    return F.conv2d(x, weight, bias, padding=padding, dilation=dilation)


class MRRPConv(nn.Module):
    """A 3x3 conv whose one weight serves every branch, each at its own
    dilation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 2, 3), bias: bool = True, device=None):
        super().__init__()
        self.dilations = tuple(dilations)
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if bias else None
        if device is None or torch.device(device).type != "meta":
            # flax's he_uniform (the JAX kernel's initializer) and a zero bias
            bound = math.sqrt(6.0 / (in_channels * kernel_size ** 2))
            nn.init.uniform_(self.weight, -bound, bound)
            if self.bias is not None:
                nn.init.zeros_(self.bias)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """xs (B, C, H, W), B = len(dilations) -> (B, out_channels, H, W)."""
        if xs.shape[0] != len(self.dilations):
            raise ValueError(f"{xs.shape[0]} branches for dilations {self.dilations}")
        k = self.kernel_size // 2
        return torch.cat([branch_conv(xs[i:i + 1], self.weight, self.bias, d, d * k)
                          for i, d in enumerate(self.dilations)])


class MRRPPlainStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_conv: int = 3,
                 dilations: Sequence[int] = (1, 2, 3), pool_stride: int = 0, device=None):
        super().__init__()
        self.pool_stride = pool_stride  # 0 = no pool; else 2x2 maxpool, this stride
        self.num_conv = num_conv
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", MRRPConv(
                in_channels if i == 0 else out_channels, out_channels, 3, dilations,
                device=device))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_conv):
            xs = F.relu(getattr(self, f"conv{i + 1}")(xs))
        if self.pool_stride:
            xs = F.max_pool2d(xs, 2, stride=self.pool_stride)
        return xs


class MRRPVGG16(nn.Module):
    """VGG16 whose last stage is the MRRP pyramid."""

    out_channels = 512

    def __init__(self, freeze_at: int = 2, branch_dilations: Sequence[int] = (1, 2, 3),
                 device=None):
        super().__init__()
        spec = [  # (name, in, out, num_conv, pool stride)
            ("plain1", 3, 64, 2, 2),
            ("plain2", 64, 128, 2, 2),
            ("plain3", 128, 256, 3, 2),
            ("plain4", 256, 512, 3, 1),
        ]
        self.stage_names = [s[0] for s in spec] + ["plain5"]
        for name, cin, cout, n, pool in spec:
            self.add_module(name, PlainStage(cin, cout, n, 1, pool, device=device))
        self.plain5 = MRRPPlainStage(512, 512, 3, branch_dilations, device=device)
        self.num_branch = len(tuple(branch_dilations))
        for name in self.stage_names[:freeze_at]:
            getattr(self, name).requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (1, 3, H, W) BGR mean-subtracted -> (B, 512, H/8, W/8)."""
        if x.shape[0] != 1:
            raise ValueError(f"MRRPVGG16 takes one image, got {x.shape[0]}")
        for name in self.stage_names[:-1]:
            x = getattr(self, name)(x)
        return self.plain5(x.expand(self.num_branch, *x.shape[1:]))
