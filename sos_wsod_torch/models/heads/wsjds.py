"""The WSJDS ROI head: weakly supervised detection and segmentation, each
supervising the other.

Counterpart of ``sos_wsod_tpu/models/heads/wsjds.py`` (the reference's
WSJDSROIHeads): the CSC detection head (``heads/csc.py``) plus
  - detection -> segmentation: the CPG maps thresholded into {pos, neg,
    ignore} targets with balancing weights (tau 0.7, fg 0.1, bg 0.005);
  - segmentation: the ASPP head (``heads/aspp.py``) on the backbone's map,
    upsampled to the CPG maps' size, and its weighted BCE; with
    ``constraint``, the dense CRF's consistency loss (the CRF on the host);
  - segmentation -> detection: the peak-normalised sigmoid masks, detached,
    enter the CSC op as CPG maps and give a second pair of CSC losses,
    ``mask_``-prefixed, weighted 0.1 (the trainers sum the keys that start
    with "loss", as the JAX step does, so these are logged and not trained
    on);
  - inference: the CSC head's scores (``predict``) and the (K, H, W)
    sigmoid masks upsampled to the canvas (``predict_masks``);
    ``crop_instance_masks`` cuts each detection's class mask to its integer
    box.
Past WSL.CSC_MAX_ITER (``use_csc`` False) the JAX package keeps one program
and multiplies ``loss_sem_seg`` and ``loss_constraint`` by 0; so does the
port, which gives the ASPP a zero gradient (not none: SGD then still applies
its weight decay and momentum, and DDP counts it as used), and the ``mask_``
losses become 0.1 x the plain MIL loss. The DAN runs before the ASPP, so a
forward after ``compute_cpgs`` with the dropout generator restored draws the
same DAN masks as the CPG forward did. Profiler ranges: the CSC head's, and
``sem_seg`` (ASPP, upsample, loss, masks) and ``crf`` (the host round trip).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from .aspp import (ASPPHead, constraint_loss, crf_constraint, resize_bilinear,
                   seg_targets_from_cpg, sem_seg_loss)
from .csc import CSCROIHead
from .wsddn import mil_image_scores


class WSJDSROIHead(CSCROIHead):
    """CSC detection + ASPP segmentation with det <-> seg supervision."""

    seg_fg_threshold = 0.1
    seg_bg_threshold = 0.005
    seg_loss_weight = 1.0
    mask_csc_loss_weight = 0.1

    def __init__(self, in_features: int, seg_in_channels: int, num_classes: int = 20,
                 mean_loss: bool = True, tau: float = 0.7, constraint: bool = False,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5,
                 aspp_dims: Sequence[int] = (1024, 1024), aspp_dropout: float = 0.5,
                 device=None):
        super().__init__(in_features, num_classes, mean_loss, dan_dims, dan_dropout,
                         device=device)
        self.tau = tau
        self.constraint = constraint
        self.sem_seg_head = ASPPHead(seg_in_channels, num_classes, tuple(aspp_dims),
                                     dropout_rate=aspp_dropout, device=device)

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor, cpgs: torch.Tensor, seg_features: torch.Tensor,
               image: torch.Tensor, use_csc: bool,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """cpgs (K, H, W) in the image coordinates of ``boxes``;
        seg_features (Hf, Wf, C) the backbone's map; image (H, W, 3) the raw
        pixels (read only with ``constraint``); ``use_csc`` False past
        WSL.CSC_MAX_ITER."""
        scores = self.scores(pooled, prop_valid, generator)
        preds_img = mil_image_scores(scores.detach())
        losses = self._csc_losses(scores, cpgs, boxes, prop_valid, gt_classes_oh, use_csc)
        active = float(use_csc)
        with record_function("sem_seg"):
            targets, weights = seg_targets_from_cpg(
                cpgs, gt_classes_oh, preds_img, tau=self.tau,
                fg_threshold=self.seg_fg_threshold, bg_threshold=self.seg_bg_threshold)
            seg_up = resize_bilinear(self.sem_seg_head(seg_features, generator),
                                     tuple(cpgs.shape[1:]))
            losses["loss_sem_seg"] = sem_seg_loss(seg_up, targets, weights,
                                                  self.seg_loss_weight) * active
            x_sigmoid = torch.sigmoid(seg_up.float())
        if self.constraint:
            with record_function("crf"):
                x_crf, w_crf = crf_constraint(image, x_sigmoid)
            with record_function("sem_seg"):
                losses["loss_constraint"] = constraint_loss(x_sigmoid, x_crf, w_crf) * active
        with record_function("sem_seg"):
            masks = x_sigmoid.detach()
            mask_cpgs = masks / masks.amax(dim=(1, 2), keepdim=True).clamp(min=1e-12)
        losses.update(self._csc_losses(scores, mask_cpgs, boxes, prop_valid, gt_classes_oh,
                                       use_csc, prefix="mask_",
                                       loss_weight=self.mask_csc_loss_weight))
        return losses

    def predict_masks(self, seg_features: torch.Tensor, image_size: Tuple[int, int]
                      ) -> torch.Tensor:
        """The (K, H, W) class masks: the f32 sigmoid of the ASPP logits on
        ``seg_features``, upsampled to ``image_size``. With the inherited
        ``predict`` (the scores with a zero background column, the
        proposals) it makes the JAX head's ``predict``."""
        with record_function("sem_seg"):
            return resize_bilinear(torch.sigmoid(self.sem_seg_head(seg_features).float()),
                                   image_size)


def crop_instance_masks(masks: torch.Tensor, pred_boxes: torch.Tensor,
                        pred_classes: torch.Tensor) -> torch.Tensor:
    """Each detection's mask: its class's mask (``masks`` (K, H, W)) zeroed
    outside its box, the coordinates truncated toward zero. pred_boxes
    (N, 4), pred_classes (N,) -> (N, H, W)."""
    _, h, w = masks.shape
    per_det = masks[pred_classes.long()]
    x0, y0, x1, y1 = (pred_boxes[:, i].to(torch.int32)[:, None, None] for i in range(4))
    ys = torch.arange(h, device=masks.device)[None, :, None]
    xs = torch.arange(w, device=masks.device)[None, None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return torch.where(inside, per_det, 0.0)
