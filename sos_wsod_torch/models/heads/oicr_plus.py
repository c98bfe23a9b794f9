"""OICR+ head, inference: DAN + WSDDN + K OICR branches.

Counterpart of ``OICRPlusHead`` in ``sos_wsod_tpu/models/heads/oicr_plus.py``
(``_features`` and ``predict``). The pooled features arrive channels-last with
the objectness weighting already applied by the pooler (``row_scale``). The
training losses and pseudo-GT mining are not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ...core.boxes import apply_deltas
from .dan import DAN
from .oicr import OICRBranch
from .wsddn import WSDDNHead


class OICRPlusHead(nn.Module):
    bbox_reg_weights = (10.0, 10.0, 5.0, 5.0)

    def __init__(self, in_features: int, num_classes: int = 20, refine_k: int = 4,
                 refine_reg: Sequence[bool] = (True, True, True, True),
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5,
                 device=None):
        super().__init__()
        self.refine_k = refine_k
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)
        for k in range(refine_k):
            self.add_module(f"box_refinery_{k}", OICRBranch(
                dan_dims[-1], num_classes, has_reg=refine_reg[k], device=device))

    @property
    def refine(self) -> List[OICRBranch]:
        return [getattr(self, f"box_refinery_{k}") for k in range(self.refine_k)]

    def _features(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled: (P, PH, PW, C), objectness-weighted -> (P, F)."""
        return self.dan(pooled)

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Branch-ensembled inference (reference fast_rcnn_oicr.py:674-736):
        mean softmax over the K branches and mean deltas, decoded against the
        proposals. Returns (scores (P, K+1), pred_boxes (P, K*4)), float32."""
        feats = self._features(pooled)
        probs = None
        deltas = None
        for branch in self.refine:
            sc, dl = branch(feats)
            pk = torch.softmax(sc.float(), dim=-1)
            probs = pk if probs is None else probs + pk
            dk = dl.float()
            deltas = dk if deltas is None else deltas + dk
        probs = probs / self.refine_k
        deltas = deltas / self.refine_k
        return probs, apply_deltas(deltas, boxes.float(), self.bbox_reg_weights)
