"""DiscriminativeAdaptionNeck (DAN) box head.

Counterpart of ``sos_wsod_tpu/models/heads/dan.py`` for the OICR+ config (no
convs): flatten the channels-last pooled ROIs in (h, w, c) order, then
FC -> ReLU -> Dropout per entry of ``fc_dims``. fc1's input rows are in
(h, w, c) order; ``engine.weights`` permutes torch/caffe (c, h, w) weights
to match. Dropout runs in training mode only, with its masks drawn from the
``generator`` the caller passes (the trainer's seeded one), else from
PyTorch's default generator.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F


class DAN(nn.Module):
    def __init__(self, in_features: int, fc_dims: Sequence[int] = (4096, 4096),
                 dropout_rate: float = 0.5, device=None):
        super().__init__()
        dims = [in_features, *fc_dims]
        for i in range(len(fc_dims)):
            self.add_module(f"fc{i + 1}", nn.Linear(dims[i], dims[i + 1], device=device))
        self.num_fc = len(fc_dims)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (P, PH, PW, C) -> (P, fc_dims[-1])."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = dropout(F.relu(getattr(self, f"fc{i + 1}")(x)), self.dropout_rate, self.training,
                        generator)
        return x


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout in training mode, its keep mask drawn from
    ``generator`` (PyTorch's default generator when None)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))
