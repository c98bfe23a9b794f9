"""Feature Pyramid Network over ResNet stages.

Counterpart of ``sos_wsod_tpu/models/backbones/fpn.py`` (detectron2 FPN:
lateral 1x1 and output 3x3 convs, top-down nearest x2, sum fuse, p6 from p5).
The top-down path repeats each cell 2 x 2 (nearest) and crops to the
lateral's shape; p6 is a stride-2 subsample of p5 (LastLevelMaxPool's 1x1
max pool). Module names mirror the JAX tree (``fpn_lateral2``,
``fpn_output2``, ..., ``bottom_up``, ``fpn``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .resnet import ResNet


class FPN(nn.Module):
    """in_features low to high resolution first, e.g. res2..res5 with
    strides 4..32; returns {"p2".."p5"} plus "p6" with the top block."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 in_strides: Sequence[int] = (4, 8, 16, 32), out_channels: int = 256,
                 fuse_type: str = "sum", top_block: bool = True, device=None):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FPN fuse_type {fuse_type!r}")
        self.in_features = tuple(in_features)
        self.in_strides = tuple(in_strides)
        self.fuse_type = fuse_type
        self.top_block = top_block
        for i, cin in enumerate(in_channels):
            self.add_module(f"fpn_lateral{i + 2}", nn.Conv2d(cin, out_channels, 1, device=device))
            self.add_module(f"fpn_output{i + 2}",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1, device=device))

    @property
    def out_feature_strides(self) -> Dict[str, int]:
        out = {f"p{i + 2}": s for i, s in enumerate(self.in_strides)}
        if self.top_block:
            out[f"p{len(self.in_strides) + 2}"] = self.in_strides[-1] * 2
        return out

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        n = len(self.in_features)
        laterals = [getattr(self, f"fpn_lateral{i + 2}")(bottom_up[f])
                    for i, f in enumerate(self.in_features)]
        merged = [None] * n
        merged[n - 1] = laterals[n - 1]
        for i in range(n - 2, -1, -1):
            h, w = laterals[i].shape[-2:]
            up = F.interpolate(merged[i + 1], scale_factor=2.0, mode="nearest")[..., :h, :w]
            merged[i] = laterals[i] + up
            if self.fuse_type == "avg":
                merged[i] = merged[i] / 2.0
        outputs = {f"p{i + 2}": getattr(self, f"fpn_output{i + 2}")(merged[i]) for i in range(n)}
        if self.top_block:
            outputs[f"p{n + 2}"] = F.max_pool2d(outputs[f"p{n + 1}"], 1, stride=2)
        return outputs


class ResNetFPN(nn.Module):
    """ResNet + FPN (build_resnet_fpn_backbone): returns p2..p6, NCHW."""

    def __init__(self, depth: int = 50, freeze_at: int = 2, out_channels: int = 256,
                 device=None):
        super().__init__()
        self.bottom_up = ResNet(depth=depth, freeze_at=freeze_at,
                                out_features=("res2", "res3", "res4", "res5"), device=device)
        self.fpn = FPN(out_channels=out_channels, device=device)

    @property
    def out_feature_strides(self) -> Dict[str, int]:
        return {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.fpn(self.bottom_up(x))
