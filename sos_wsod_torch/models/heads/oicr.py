"""OICR refinement branch: per-branch classifier + box regressor.

Counterpart of ``OICRBranch`` in ``sos_wsod_tpu/models/heads/oicr.py``:
cls_score Linear(F, K+1), bbox_pred Linear(F, K*4); a branch without
regression returns zero deltas.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class OICRBranch(nn.Module):
    def __init__(self, in_features: int, num_classes: int, has_reg: bool = True,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = nn.Linear(in_features, num_classes + 1, device=device)
        self.bbox_pred = (nn.Linear(in_features, num_classes * 4, device=device)
                          if has_reg else None)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (P, F) -> (scores (P, K+1), deltas (P, K*4))."""
        scores = self.cls_score(x)
        if self.bbox_pred is None:
            return scores, scores.new_zeros((x.shape[0], self.num_classes * 4))
        return scores, self.bbox_pred(x)
