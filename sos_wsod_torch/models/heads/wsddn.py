"""WSDDN MIL output layer: the (cls, det) Linear pair.

Counterpart of ``WSDDNHead`` in ``sos_wsod_tpu/models/heads/wsddn.py``. The
JAX package packs both into one matmul to fill the TPU's 128-lane tiles; here
they are two ``nn.Linear``. Inference does not use them; they complete the
state dict for the training port.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class WSDDNHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int, device=None):
        super().__init__()
        self.cls = nn.Linear(in_features, num_classes, device=device)
        self.det = nn.Linear(in_features, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (P, F) -> raw (C, D) logits, each (P, K)."""
        return self.cls(x), self.det(x)
