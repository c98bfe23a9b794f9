"""CMIL (Continuation Multiple Instance Learning) ROI head.

Counterpart of ``sos_wsod_tpu/models/heads/cmil.py`` (the reference's
CMILROIHeads and WSDDNOutputLayers.forward_cmil):
  - the raw cls and det logits are merged over cliques by ROIMerge
    (``ops/roi_merge.py``) with the continuation threshold lambda(iter),
    over the proposal scores S = sum over classes of the WSDDN scores and the
    proposals' IoU; the MIL loss runs over softmax(MC, classes) x
    softmax(MD, cliques);
  - K refinement branches on top-1 pseudo-GT, weighted by the image-level
    class scores of the merged MIL scores; branch 0 mines the merged rows
    (a clique id indexes the proposal array, as in the reference);
  - epoch schedule: max_epoch = max(int(MAX_ITER / SIZE_EPOCH), 1).
Padded slots get score -1e9 and IoU -1, so they form singleton cliques after
the real ones, and a merged row is valid when its clique holds a valid
proposal. Inference is the mean of the K branch softmaxes, no merge.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.boxes import pairwise_iou
from ...core.matcher import Matcher
from ...ops.roi_merge import roi_merge
from .dan import DAN
from .oicr import OICRBranch, weighted_ce_loss
from .oicr_plus import label_and_sample
from .single_view import top1_mining
from .wsddn import WSDDNHead, mil_image_scores, mil_loss, wsddn_scores


class CMILROIHead(nn.Module):
    """DAN + continuation-merged WSDDN MIL + K refinement branches."""

    def __init__(self, in_features: int, num_classes: int = 20, refine_k: int = 3,
                 mean_loss: bool = True, size_epoch: int = 5000, max_iter: int = 200000,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.refine_k = refine_k
        self.mean_loss = mean_loss
        self.size_epoch = size_epoch
        self.max_epoch = max(int(max_iter / size_epoch), 1)
        self.matcher = Matcher([0.5, 0.6], [0, -1, 1])
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)
        for k in range(refine_k):
            self.add_module(f"box_refinery_{k}", OICRBranch(dan_dims[-1], num_classes,
                                                             has_reg=False, device=device))

    @property
    def refine(self):
        return [getattr(self, f"box_refinery_{k}") for k in range(self.refine_k)]

    def merged_scores(self, c, d, boxes, prop_valid, cur_iter: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """forward_cmil: (merged MIL scores (P, K), merged-row validity (P,))."""
        obn = wsddn_scores(c, d, prop_valid).sum(dim=1)
        pair_valid = prop_valid[:, None] & prop_valid[None, :]
        iou = torch.where(pair_valid, pairwise_iou(boxes.float(), boxes.float()), -1.0)
        s = torch.where(prop_valid, obn, -1e9)
        c32 = torch.where(prop_valid[:, None], c.float(), 0.0)
        d32 = torch.where(prop_valid[:, None], d.float(), 0.0)
        mc, md, ids, _ = roi_merge(s, iou, c32, d32, cur_iter, self.max_epoch, self.size_epoch)
        merged_valid = torch.zeros_like(ids).scatter_reduce(0, ids, prop_valid.long(), "amax")
        return wsddn_scores(mc, md, merged_valid.bool()), merged_valid.bool()

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor, generator: Optional[torch.Generator] = None,
               cur_iter: int = 0) -> Dict[str, torch.Tensor]:
        """``cur_iter``: the training step (the trainer's iteration), which
        sets lambda."""
        with record_function("box_head"):
            feats = self.dan(pooled, generator)
            c, d = self.wsddn(feats)
        with record_function("mining"):
            merged, row_valid = self.merged_scores(c, d, boxes, prop_valid, int(cur_iter))
        losses = {"loss_cls": mil_loss(merged, gt_classes_oh, self.mean_loss)}
        img_scores = mil_image_scores(merged).detach()
        prev = merged.detach()
        for k, branch in enumerate(self.refine):
            with record_function("mining"):
                # the JAX top1_mining_weighted: get_pgt_top_k with the
                # image-level class scores as the weights
                gt = top1_mining(prev, boxes, row_valid, gt_classes_oh, img_scores)
                cls, weights, _, _ = label_and_sample(gt, boxes, prop_valid, self.matcher,
                                                      self.num_classes)
            with record_function("box_head"):
                sc, _ = branch(feats)
            losses[f"loss_cls_r{k}"] = weighted_ce_loss(sc, cls, weights, prop_valid)
            prev = torch.softmax(sc.float(), dim=-1)[:, :self.num_classes].detach()
            row_valid = prop_valid
        return losses

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean branch softmax (P, K+1), the proposals for every class)."""
        feats = self.dan(pooled)
        probs = None
        for branch in self.refine:
            pk = torch.softmax(branch(feats)[0].float(), dim=-1)
            probs = pk if probs is None else probs + pk
        return probs / self.refine_k, boxes.float().repeat(1, self.num_classes)
