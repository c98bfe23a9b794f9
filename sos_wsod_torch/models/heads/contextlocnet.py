"""ContextLocNet ROI head (the contrastive-S model).

Counterpart of ``sos_wsod_tpu/models/heads/contextlocnet.py`` (the
reference's ContextLocNetROIHeads and forward_contextlocnet): the ROILoopPool
output stacks [box; frame; context] as 3P rows, already weighted by
objectness + 1 (the pooler fuses it, ``ops/roi_loop_pool.py``); the DAN runs
over all 3P rows, then the WSDDN layers: the classification stream is
cls(x_box), the detection stream det(x_frame) - det(x_context), and the
scores and loss are plain WSDDN MIL. Inference appends a zero background
column and returns the proposals.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from .dan import DAN
from .wsddn import WSDDNHead, mil_loss, wsddn_scores


class ContextLocNetROIHead(nn.Module):
    """DAN + contrastive WSDDN over [box; frame; context] ROI triples."""

    def __init__(self, in_features: int, num_classes: int = 20, mean_loss: bool = True,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5, device=None):
        super().__init__()
        self.mean_loss = mean_loss
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)

    def _scores(self, pooled3: torch.Tensor, prop_valid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pooled3 (3P, PH, PW, C) -> (P, K) MIL scores."""
        p = pooled3.shape[0] // 3
        with record_function("box_head"):
            c_all, d_all = self.wsddn(self.dan(pooled3, generator))
        return wsddn_scores(c_all[:p], d_all[p:2 * p] - d_all[2 * p:], prop_valid)

    def losses(self, pooled3: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        scores = self._scores(pooled3, prop_valid, generator)
        return {"loss_cls": mil_loss(scores, gt_classes_oh, self.mean_loss)}

    def predict(self, pooled3: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = self._scores(pooled3, prop_valid)
        return torch.cat([scores, scores.new_zeros((scores.shape[0], 1))], dim=1), boxes.float()
