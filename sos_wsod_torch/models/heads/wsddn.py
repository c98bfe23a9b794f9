"""WSDDN MIL output layer and loss.

Counterpart of ``sos_wsod_tpu/models/heads/wsddn.py``: the (cls, det) Linear
pair (the JAX package packs both into one matmul to fill the TPU's 128-lane
tiles; here they are two ``nn.Linear``), and

    scores = softmax(C, over classes) * softmax(D, over proposals)
    image  = clamp(sum over proposals of scores, 1e-6, 1 - 1e-6)
    loss   = BCE(image, one-hot labels), mean (or sum) over classes

in f32, with padded proposal slots masked out of the proposal-axis softmax
(their scores and gradients are zero).
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


def wsddn_scores(c: torch.Tensor, d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(P, K), (P, K), (P,) -> (P, K) f32 MIL proposal scores; padded rows
    are zero."""
    c32 = c.float()
    cls_sm = torch.exp(c32 - c32.max(dim=1, keepdim=True).values)
    cls_sm = cls_sm / cls_sm.sum(dim=1, keepdim=True)
    d_masked = torch.where(valid[:, None], d.float(), float("-inf"))
    det_sm = torch.exp(d_masked - d_masked.max(dim=0, keepdim=True).values)
    det_sm = torch.where(valid[:, None], det_sm, 0.0)
    det_sm = det_sm / det_sm.sum(dim=0, keepdim=True).clamp(min=1e-20)
    return torch.where(valid[:, None], cls_sm * det_sm, 0.0)


def mil_image_scores(scores: torch.Tensor) -> torch.Tensor:
    """(P, K) -> (K,) clamped image-level class probabilities."""
    return scores.sum(dim=0).clamp(1e-6, 1.0 - 1e-6)


def mil_loss(scores: torch.Tensor, gt_classes_oh: torch.Tensor,
             mean_loss: bool = True) -> torch.Tensor:
    """BCE between the image-level scores and the one-hot labels, mean over
    classes (WSL.MEAN_LOSS) or their sum."""
    p = mil_image_scores(scores)
    t = gt_classes_oh.float()
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    return bce.mean() if mean_loss else bce.sum()
