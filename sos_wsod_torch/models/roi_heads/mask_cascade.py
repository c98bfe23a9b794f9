"""Mask head and Cascade ROI heads for the stage-2/3 Faster R-CNN stack.

Counterpart of ``sos_wsod_tpu/models/roi_heads/mask_cascade.py`` (ubteacher's
StandardROIMaskHeadsPseudoLab and CascadeROIHeadsPseudoLab, detectron2's
mask_head.py and cascade_rcnn.py):
 - ``MaskRCNNConvUpsampleHead``: 4 conv3x3 + ReLU, a 2x2 stride-2
   ConvTranspose2d + ReLU, a 1x1 predictor of K channels (1 when class
   agnostic), NCHW;
 - ``crop_gt_masks``: each sample's matched GT mask cropped to its box and
   resized to R x R by aligned bilinear sampling (d2's crop_and_resize),
   then thresholded at 0.5;
 - ``mask_rcnn_loss``: BCE with logits on the GT class's channel, summed
   over the foreground samples over max(fg R^2, 1);
 - ``MaskROIHeads``: the mask branch over given samples, beside a box head;
 - ``CascadeROIHeads``: three stages at IoU 0.5, 0.6 and 0.7, class-agnostic
   box regression with per-stage weights; stage 0 samples, stages 1 and 2
   re-match the boxes the previous stage decoded (clipped, no gradient)
   without sampling; losses ``loss_*_stage{k}``; inference averages the
   stages' softmax scores and takes the last stage's boxes.
Neither is built by a config or reached by a CLI, in either package
(``MODEL.MASK_ON`` is read by no module).

The GT masks are not gathered per sample, as the JAX package does ((S, Hm,
Wm): 1.38 GB in f32 for 512 samples on a 704 x 960 canvas). The G masks are
the channels of one (Hm, Wm, G) map, padded to kernel D's vector width of
channels, every box is pooled once through ``ops/roi_align.py:roi_align``
(aligned, adaptive grid capped at 8), and each sample takes its matched
channel. The sample positions depend only on the box and each channel is
pooled on its own, so this is the per-sample crop exactly.

The pooled features are NCHW views of channels-last ROIs (kernel D's
layout on the card); the mask head's convs run in channels_last.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import apply_deltas, clip_boxes, pairwise_iou
from ...core.matcher import Matcher
from ...ops.roi_align import roi_align
from .standard import (FastRCNNConvFCHead, FastRCNNOutputLayers, add_ground_truth_to_proposals,
                       fast_rcnn_losses, label_and_sample_proposals, multilevel_roi_align)

MASK_CHANNEL_ALIGN = 4      # f32 channels in kernel D's 16-byte vector


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 20, num_conv: int = 4,
                 conv_dim: int = 256, cls_agnostic_mask: bool = False, device=None):
        super().__init__()
        self.num_conv = num_conv
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(c, conv_dim, 3, padding=1,
                                                          device=device))
            c = conv_dim
        self.deconv = nn.ConvTranspose2d(c, conv_dim, 2, stride=2, device=device)
        self.predictor = nn.Conv2d(conv_dim, 1 if cls_agnostic_mask else num_classes, 1,
                                   device=device)
        for m in self.children():   # the JAX initializers
            if m is self.predictor:
                nn.init.normal_(m.weight, std=0.001)
            else:
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, C, R, R) -> mask logits (S, K or 1, 2R, 2R)."""
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


def crop_gt_masks(gt_masks: torch.Tensor, boxes: torch.Tensor, matched: torch.Tensor,
                  out_size: int = 28) -> torch.Tensor:
    """gt_masks (G, Hm, Wm) {0, 1}, boxes (S, 4), matched (S,) GT rows ->
    (S, out_size, out_size) f32 targets: each sample's matched mask within
    its box, bilinear (aligned), >= 0.5."""
    g, hm, wm = gt_masks.shape
    gp = -(-g // MASK_CHANNEL_ALIGN) * MASK_CHANNEL_ALIGN
    masks = torch.zeros((hm, wm, gp), dtype=torch.float32, device=gt_masks.device)
    masks[..., :g] = gt_masks.permute(1, 2, 0)
    s = boxes.shape[0]
    pooled = roi_align(masks, boxes.float(), torch.ones(s, dtype=torch.bool, device=boxes.device),
                       spatial_scale=1.0, output_size=(out_size, out_size), sampling_ratio=0,
                       aligned=True)                                   # (S, Gp, R, R)
    crops = pooled.gather(1, matched.long()[:, None, None, None].expand(s, 1, out_size,
                                                                       out_size))[:, 0]
    return (crops >= 0.5).float()


def _class_channel(logits: torch.Tensor, classes: torch.Tensor, agnostic: bool) -> torch.Tensor:
    """(S, K, R, R) -> (S, R, R): channel 0 when class agnostic, else each
    sample's class clipped to [0, K - 1]."""
    s, k, r, _ = logits.shape
    if agnostic:
        return logits[:, 0]
    safe = classes.long().clamp(0, k - 1)
    return logits.gather(1, safe[:, None, None, None].expand(s, 1, r, r))[:, 0]


def mask_rcnn_loss(mask_logits: torch.Tensor, gt_classes: torch.Tensor, fg: torch.Tensor,
                   mask_targets: torch.Tensor, cls_agnostic: bool = False) -> torch.Tensor:
    """mask_logits (S, K, R, R), gt_classes (S,), fg (S,), mask_targets
    (S, R, R) -> the BCE with logits of the foreground samples' class
    channels, summed over max(fg R^2, 1) (d2 mask_rcnn_loss)."""
    r = mask_logits.shape[-1]
    z = _class_channel(mask_logits, gt_classes, cls_agnostic).float()
    t = mask_targets
    bce = torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))
    bce = torch.where(fg[:, None, None], bce, torch.zeros_like(bce))
    denom = torch.clamp(fg.float().sum() * r * r, min=1.0)
    return bce.sum() / denom


class MaskROIHeads(nn.Module):
    """The mask branch over the samples of a box branch (the reference keeps
    both in StandardROIMaskHeadsPseudoLab; the JAX package and the port keep
    the mask branch apart, over the same samples)."""

    def __init__(self, in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 strides: Sequence[int] = (4, 8, 16, 32), in_channels: int = 256,
                 num_classes: int = 20, pooler_resolution: int = 14, num_conv: int = 4,
                 conv_dim: int = 256, cls_agnostic_mask: bool = False, device=None):
        super().__init__()
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.pooler_resolution = pooler_resolution
        self.cls_agnostic_mask = cls_agnostic_mask
        self.mask_head = MaskRCNNConvUpsampleHead(in_channels, num_classes, num_conv, conv_dim,
                                                  cls_agnostic_mask, device=device)

    def _logits(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        with record_function("roi_align"):
            pooled = multilevel_roi_align([features[f] for f in self.in_features], self.strides,
                                          boxes, valid, output_size=self.pooler_resolution,
                                          sampling_ratio=0, aligned=True)
        with record_function("mask_head"):
            # one memory format whichever pooler ran (kernel D's output is
            # channels-last already), so that cuDNN runs the same convs
            return self.mask_head(pooled.contiguous(memory_format=torch.channels_last))

    def losses(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
               valid: torch.Tensor, gt_classes: torch.Tensor, fg: torch.Tensor,
               gt_masks: torch.Tensor, matched: torch.Tensor) -> Dict[str, torch.Tensor]:
        """features per level (H, W, C); the samples' boxes (S, 4), valid,
        classes and foreground (S,); gt_masks (G, Hm, Wm) and each sample's
        matched GT row (S,) -> {"loss_mask"}."""
        logits = self._logits(features, boxes, valid)
        targets = crop_gt_masks(gt_masks, boxes, matched, 2 * self.pooler_resolution)
        return {"loss_mask": mask_rcnn_loss(logits, gt_classes, fg & valid, targets,
                                            self.cls_agnostic_mask)}

    def predict(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                valid: torch.Tensor, pred_classes: torch.Tensor) -> torch.Tensor:
        """Each detection's (2R, 2R) mask probabilities, f32 (S, 2R, 2R)."""
        logits = self._logits(features, boxes, valid)
        return torch.sigmoid(_class_channel(logits, pred_classes, self.cls_agnostic_mask).float())


class CascadeROIHeads(nn.Module):
    """Three-stage cascade with class-agnostic regression."""

    def __init__(self, in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 strides: Sequence[int] = (4, 8, 16, 32), in_channels: int = 256,
                 num_classes: int = 20, batch_size_per_image: int = 512,
                 positive_fraction: float = 0.25,
                 cascade_ious: Sequence[float] = (0.5, 0.6, 0.7),
                 cascade_weights: Sequence[Tuple[float, float, float, float]] = (
                     (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0)),
                 proposal_append_gt: bool = True, pooler_resolution: int = 7, num_fc: int = 2,
                 fc_dim: int = 1024, smooth_l1_beta: float = 0.0,
                 loss_type: str = "CrossEntropy", device=None):
        super().__init__()
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.cascade_weights = [tuple(w) for w in cascade_weights]
        self.proposal_append_gt = proposal_append_gt
        self.pooler_resolution = pooler_resolution
        self.smooth_l1_beta = smooth_l1_beta
        self.loss_type = loss_type
        self.num_stages = len(cascade_ious)
        for k in range(self.num_stages):
            self.add_module(f"box_head_{k}", FastRCNNConvFCHead(
                in_channels, pooler_resolution, 0, 256, num_fc, fc_dim, device=device))
            self.add_module(f"box_predictor_{k}", FastRCNNOutputLayers(
                fc_dim, num_classes, cls_agnostic_bbox_reg=True, device=device))
        self.matchers = [Matcher([iou], [0, 1]) for iou in cascade_ious]

    def _run_stage(self, k: int, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                   valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage k's class logits (S, K + 1) and deltas (S, 4)."""
        with record_function("roi_align"):
            pooled = multilevel_roi_align([features[f] for f in self.in_features], self.strides,
                                          boxes, valid, output_size=self.pooler_resolution,
                                          sampling_ratio=0, aligned=True)
        with record_function("box_head"):
            x = getattr(self, f"box_head_{k}")(pooled.permute(0, 2, 3, 1))
            return getattr(self, f"box_predictor_{k}")(x)

    def _decode(self, k: int, deltas: torch.Tensor, boxes: torch.Tensor,
                image_hw: torch.Tensor) -> torch.Tensor:
        out = apply_deltas(deltas.float(), boxes, self.cascade_weights[k])[:, :4]
        return clip_boxes(out, image_hw[0], image_hw[1])

    def losses(self, features: Dict[str, torch.Tensor], prop_boxes: torch.Tensor,
               prop_logits: torch.Tensor, prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_valid: torch.Tensor, generator: torch.Generator,
               image_hw: torch.Tensor, *, append_gt: bool = True) -> Dict[str, torch.Tensor]:
        """One image: features per level (H, W, C), detached proposals, the
        gt, the generator of stage 0's sampling draws and the image's (h, w)
        -> loss_cls_stage{k}, loss_box_reg_stage{k}."""
        if self.proposal_append_gt and append_gt:
            prop_boxes, prop_logits, prop_valid = add_ground_truth_to_proposals(
                prop_boxes, prop_logits, prop_valid, gt_boxes, gt_valid)
        losses = {}
        boxes = prop_boxes
        for k in range(self.num_stages):
            with record_function("losses"):
                if k == 0:
                    boxes, s_cls, s_match, valid, fg, _ = label_and_sample_proposals(
                        boxes, prop_valid, gt_boxes, gt_classes, gt_valid, self.matchers[0],
                        generator, batch_size_per_image=self.batch_size_per_image,
                        positive_fraction=self.positive_fraction, num_classes=self.num_classes)
                else:   # re-match without sampling (d2 _match_and_label_boxes)
                    s_match, labels = self.matchers[k](pairwise_iou(gt_boxes, boxes), gt_valid)
                    bg = torch.full_like(s_match, self.num_classes)
                    s_cls = torch.where(labels == 1, gt_classes.long()[s_match], bg)
                    s_cls = torch.where(gt_valid.any(), s_cls, bg)
                    fg = valid & (s_cls < self.num_classes)
            scores, deltas = self._run_stage(k, features, boxes, valid)
            with record_function("losses"):
                stage = fast_rcnn_losses(
                    scores, deltas, boxes, s_cls, gt_boxes[s_match], valid, fg,
                    num_classes=self.num_classes, bbox_reg_weights=self.cascade_weights[k],
                    smooth_l1_beta=self.smooth_l1_beta, loss_type=self.loss_type)
                losses.update({f"{n}_stage{k}": v for n, v in stage.items()})
                boxes = self._decode(k, deltas, boxes, image_hw).detach()
        return losses

    def predict_scores_boxes(self, features: Dict[str, torch.Tensor], prop_boxes: torch.Tensor,
                             prop_valid: torch.Tensor, image_hw: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stages' mean softmax scores (S, K + 1) f32 and the last
        stage's boxes (S, 4) (d2 CascadeROIHeads inference)."""
        boxes = prop_boxes
        all_scores = []
        for k in range(self.num_stages):
            scores, deltas = self._run_stage(k, features, boxes, prop_valid)
            all_scores.append(torch.softmax(scores.float(), dim=-1))
            boxes = self._decode(k, deltas, boxes, image_hw)
        return sum(all_scores) / len(all_scores), boxes
