"""UWSOD ROI head: WSOD with learned proposals and regressing refinement.

Counterpart of ``sos_wsod_tpu/models/heads/uwsod.py`` (the reference's
UWSODROIHeads):
  - the proposals' objectness weight is sigmoid(objectness + 1) when they
    come from the learned RPN (``rpn_on``), objectness + 1 otherwise
    (``objectness_weight``); the RPN's logits carry no gradient, so the
    meta-architecture fuses the weight into the pool as its ``row_scale``
    and ``pooled`` arrives weighted;
  - DAN + WSDDN MIL loss, then K refinement branches; branch k's pseudo-GT
    is mined from branch k-1's softmax AND its regressed class-specific
    boxes (P, K, 4) (branch 0: the MIL scores and the proposals), by the
    top-1 proposal of each present class weighted by the image-level MIL
    scores, or by MIST (``refine_mist``). MIST ranks by the scores but runs
    its NMS on the boxes of class 0 for every class, then takes each seed's
    own class box, as the JAX package does;
  - each proposal is labelled through the [0.5, 0.6] / [0, -1, 1] matcher
    and regresses to its MATCHED pseudo-GT box; with ``sampling_on`` a
    budget of foreground and background proposals keeps its label and the
    rest is ignored (-1);
  - the LAST branch's top-1 mining gives the pseudo-GT that trains the
    weakly-supervised RPN (``losses`` returns it);
  - ``predict`` averages the K softmaxes and the K delta sets
    (``OICRROIHead.predict``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ...core.boxes import apply_deltas, pairwise_iou
from ...core.instances import GroundTruth
from ...core.matcher import Matcher
from ...core.sampling import subsample_masks
from .oicr import box_reg_loss, weighted_ce_loss
from .oicr_plus import mist_mining
from .single_view import BBOX_REG_WEIGHTS, OICRROIHead
from .wsddn import mil_image_scores, mil_loss, wsddn_scores


def objectness_weight(objectness: torch.Tensor, rpn_on: bool = True) -> torch.Tensor:
    """(P,) proposal logits -> (P,) f32 weights of the pooled ROIs."""
    x = objectness.float() + 1.0
    return torch.sigmoid(x) if rpn_on else x


def gather_class_boxes(prop_boxes: torch.Tensor, idx: torch.Tensor,
                       cls: torch.Tensor) -> torch.Tensor:
    """prop_boxes (P, 4) or (P, K, 4) -> the box of each (proposal idx,
    class cls) pair."""
    if prop_boxes.dim() == 2:
        return prop_boxes[idx]
    return prop_boxes[idx, cls]


def top1_mining_img_weighted(prev_scores: torch.Tensor, prop_boxes: torch.Tensor,
                             prop_valid: torch.Tensor, gt_classes_oh: torch.Tensor,
                             img_scores: torch.Tensor) -> GroundTruth:
    """The highest-scoring valid proposal of each class (the first on
    ties), its box of that class when ``prop_boxes`` is (P, K, 4), valid for
    the present classes, weighted by the (K,) image-level scores. Capacity
    K, one slot per class."""
    k = gt_classes_oh.shape[0]
    masked = torch.where(prop_valid[:, None], prev_scores[:, :k].float(), float("-inf"))
    idx = torch.argmax(masked, dim=0)
    scores = masked.max(dim=0).values
    valid = gt_classes_oh.bool() & torch.isfinite(scores)
    cls = torch.arange(k, device=idx.device)
    return GroundTruth(boxes=gather_class_boxes(prop_boxes, idx, cls), classes=cls,
                       scores=torch.where(valid, scores, 0.0),
                       weights=torch.where(valid, img_scores.float(), 0.0),
                       index=idx, valid=valid)


def label_and_sample_boxes(gt: GroundTruth, prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                           matcher: Matcher, num_classes: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every proposal's class (num_classes = background, -1 = ignore),
    weight, matched pseudo-GT box and foreground flag: (cls (P,), weights
    (P,), gt_boxes (P, 4), fg (P,))."""
    matched, labels = matcher(pairwise_iou(gt.boxes, prop_boxes), gt.valid)
    cls = torch.where(labels == 1, gt.classes[matched],
                      torch.where(labels == 0, num_classes, -1))
    weights = torch.where(cls == -1, 0.0, gt.weights[matched])
    weights = torch.where(gt.valid.any(), weights, 0.0)
    fg = prop_valid & (cls >= 0) & (cls < num_classes)
    return cls, weights, gt.boxes[matched], fg


class UWSODROIHead(OICRROIHead):
    """DAN + WSDDN + K regressing refinement branches + the RPN's pseudo-GT."""

    def __init__(self, in_features: int, num_classes: int = 20, refine_k: int = 4,
                 refine_reg: Sequence[bool] = (True, True, True, True),
                 refine_mist: bool = False, mist_p: float = 0.10, mist_thre: float = 0.05,
                 rpn_on: bool = True, sampling_on: bool = False,
                 batch_sizes: Sequence[int] = (4096, 4096, 4096, 4096),
                 positive_fractions: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 mean_loss: bool = True, seed_cap: int = 1024,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5,
                 device=None):
        super().__init__(in_features, num_classes, refine_k, refine_reg, mean_loss, dan_dims,
                         dan_dropout, device=device)
        self.refine_mist = refine_mist
        self.mist_p = mist_p
        self.mist_thre = mist_thre
        self.rpn_on = rpn_on
        self.sampling_on = sampling_on
        self.batch_sizes = tuple(batch_sizes)
        self.positive_fractions = tuple(positive_fractions)
        self.seed_cap = seed_cap

    def _mine(self, prev_scores, prev_boxes, prop_valid, gt_classes_oh, img_scores):
        if not self.refine_mist:
            return top1_mining_img_weighted(prev_scores, prev_boxes, prop_valid, gt_classes_oh,
                                            img_scores)
        base = prev_boxes if prev_boxes.dim() == 2 else prev_boxes[:, 0]
        gt = mist_mining(prev_scores, base, prop_valid, gt_classes_oh, mist_p=self.mist_p,
                         mist_thre=self.mist_thre, seed_cap=self.seed_cap)
        if prev_boxes.dim() == 3:
            gt = dataclasses.replace(gt, boxes=gather_class_boxes(prev_boxes, gt.index,
                                                                  gt.classes))
        return gt

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> Tuple[Dict[str, torch.Tensor], GroundTruth]:
        """pooled (P, PH, PW, C) weighted by ``objectness_weight``, boxes
        (P, 4), prop_valid (P,), gt_classes_oh (K,) -> (the f32 loss terms,
        the pseudo-GT of the RPN's loss). Dropout and the subsampling draw
        from ``generator``."""
        nc = self.num_classes
        boxes = boxes.float()
        with record_function("box_head"):
            feats = self.dan(pooled, generator)
            c, d = self.wsddn(feats)
        scores = wsddn_scores(c, d, prop_valid)
        losses = {"loss_cls": mil_loss(scores, gt_classes_oh, self.mean_loss)}
        img_scores = mil_image_scores(scores.detach())
        prev_scores, prev_boxes = scores.detach(), boxes
        for k, branch in enumerate(self.refine):
            with record_function("mining"):
                gt = self._mine(prev_scores, prev_boxes, prop_valid, gt_classes_oh, img_scores)
                cls, weights, gt_boxes, fg = label_and_sample_boxes(gt, boxes, prop_valid,
                                                                    self.matcher, nc)
                if self.sampling_on:
                    pos_keep, neg_keep = subsample_masks(
                        fg, prop_valid & (cls == nc), self.batch_sizes[k],
                        self.positive_fractions[k], generator)
                    cls = torch.where(pos_keep | neg_keep, cls, -1)
            with record_function("box_head"):
                sc, dl = branch(feats)
            with record_function("losses"):
                losses[f"loss_cls_r{k}"] = weighted_ce_loss(sc, cls, weights, prop_valid)
                if self.refine_reg[k]:
                    losses[f"loss_box_reg_r{k}"] = box_reg_loss(
                        dl, boxes, gt_boxes, cls, prop_valid, num_classes=nc,
                        beta=self.smooth_l1_beta, weights=BBOX_REG_WEIGHTS)
            prev_scores = torch.softmax(sc.detach().float(), dim=-1)[:, :nc]
            if self.refine_reg[k]:
                prev_boxes = apply_deltas(dl.detach().float(), boxes,
                                          BBOX_REG_WEIGHTS).reshape(-1, nc, 4)
            else:
                prev_boxes = boxes
        with record_function("mining"):
            rpn_gt = top1_mining_img_weighted(prev_scores, prev_boxes, prop_valid, gt_classes_oh,
                                              img_scores)
        return losses, rpn_gt
