"""Single-view WSOD ROI heads: WSDDN and classic OICR.

Counterpart of ``sos_wsod_tpu/models/heads/single_view.py`` (the
reference's WSDDNROIHeads and OICRROIHeads):
  - WSDDN: DAN + the WSDDN MIL loss; inference is the MIL proposal scores
    with a zero background column appended, on the proposals;
  - OICR: the MIL loss + K refinement branches, branch k trained on the
    top-1 proposal of each present class under the previous branch's scores
    (branch 0: the MIL scores), labelled through the [0.5, 0.6] / [0, -1, 1]
    matcher band, weighted CE (branch 0's term times 3.0) and an optional box
    regression; inference is the mean of the K branch softmaxes, decoded by
    the mean deltas when a branch regresses, else the proposals for every
    class.
``pooled`` is the channels-last (P, PH, PW, C) ROIPool output, already
weighted by objectness + 1 (the pooler fuses it, ``ops/roi_pool.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.boxes import apply_deltas
from ...core.instances import GroundTruth
from ...core.matcher import Matcher
from .dan import DAN
from .oicr import OICRBranch, box_reg_loss, weighted_ce_loss
from .oicr_plus import label_and_sample
from .wsddn import WSDDNHead, mil_loss, wsddn_scores

BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def top1_mining(prev_scores: torch.Tensor, prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                gt_classes_oh: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> GroundTruth:
    """The highest-scoring proposal of each present class (the reference's
    get_pgt_top_k with k = 1), weighted by its score, or by ``weights`` (K,)
    when given (CMIL's image-level scores). prev_scores (P, >= K); rows
    where ``prop_valid`` is False are never picked."""
    k = gt_classes_oh.shape[0]
    masked = torch.where(prop_valid[:, None], prev_scores[:, :k].float(), float("-inf"))
    scores, idx = masked.max(dim=0)
    valid = gt_classes_oh.bool() & torch.isfinite(scores)
    w = scores if weights is None else weights.float()
    return GroundTruth(boxes=prop_boxes[idx],
                       classes=torch.arange(k, device=prev_scores.device),
                       scores=torch.where(valid, scores, 0.0),
                       weights=torch.where(valid, w, 0.0),
                       index=idx, valid=valid)


class WSDDNROIHead(nn.Module):
    """MIL-only head (DAN + WSDDN)."""

    def __init__(self, in_features: int, num_classes: int = 20, mean_loss: bool = True,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5, device=None):
        super().__init__()
        self.mean_loss = mean_loss
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)

    def _scores(self, pooled, prop_valid, generator=None):
        with record_function("box_head"):
            c, d = self.wsddn(self.dan(pooled, generator))
        return wsddn_scores(c, d, prop_valid)

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        scores = self._scores(pooled, prop_valid, generator)
        return {"loss_cls": mil_loss(scores, gt_classes_oh, self.mean_loss)}

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores (P, K+1) with a zero background column, the proposals
        (P, 4))."""
        scores = self._scores(pooled, prop_valid)
        return torch.cat([scores, scores.new_zeros((scores.shape[0], 1))], dim=1), boxes.float()


class OICRROIHead(nn.Module):
    """Single-view OICR: MIL + K refinement branches with top-1 mining."""

    smooth_l1_beta = 0.0

    def __init__(self, in_features: int, num_classes: int = 20, refine_k: int = 3,
                 refine_reg: Sequence[bool] = (False, False, False), mean_loss: bool = True,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.refine_k = refine_k
        self.refine_reg = tuple(refine_reg)
        self.mean_loss = mean_loss
        self.matcher = Matcher([0.5, 0.6], [0, -1, 1])
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)
        for k in range(refine_k):
            self.add_module(f"box_refinery_{k}", OICRBranch(
                dan_dims[-1], num_classes, has_reg=self.refine_reg[k], device=device))

    @property
    def refine(self):
        return [getattr(self, f"box_refinery_{k}") for k in range(self.refine_k)]

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        nc = self.num_classes
        with record_function("box_head"):
            feats = self.dan(pooled, generator)
            c, d = self.wsddn(feats)
        scores = wsddn_scores(c, d, prop_valid)
        losses = {"loss_cls": mil_loss(scores, gt_classes_oh, self.mean_loss)}
        prev = scores.detach()
        for k, branch in enumerate(self.refine):
            with record_function("mining"):
                gt = top1_mining(prev, boxes, prop_valid, gt_classes_oh)
                cls, weights, index, _ = label_and_sample(gt, boxes, prop_valid, self.matcher,
                                                          nc)
            with record_function("box_head"):
                sc, dl = branch(feats)
            term_weight = 3.0 if k == 0 else 1.0
            losses[f"loss_cls_r{k}"] = weighted_ce_loss(sc, cls, weights, prop_valid) * term_weight
            if self.refine_reg[k]:
                losses[f"loss_box_reg_r{k}"] = box_reg_loss(
                    dl, boxes, boxes[index], cls, prop_valid, num_classes=nc,
                    beta=self.smooth_l1_beta, weights=BBOX_REG_WEIGHTS) * term_weight
            prev = torch.softmax(sc.float(), dim=-1)[:, :nc].detach()
        return losses

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean branch softmax (P, K+1), boxes (P, K*4))."""
        feats = self.dan(pooled)
        probs = deltas = None
        for branch in self.refine:
            sc, dl = branch(feats)
            pk, dk = torch.softmax(sc.float(), dim=-1), dl.float()
            probs = pk if probs is None else probs + pk
            deltas = dk if deltas is None else deltas + dk
        probs, deltas = probs / self.refine_k, deltas / self.refine_k
        if any(self.refine_reg):
            return probs, apply_deltas(deltas, boxes.float(), BBOX_REG_WEIGHTS)
        return probs, boxes.float().repeat(1, self.num_classes)
