"""Standard (Faster R-CNN) ROI heads.

Counterpart of ``sos_wsod_tpu/models/roi_heads/standard.py`` (detectron2
StandardROIHeads + FastRCNNConvFCHead + FastRCNNOutputLayers, softmax and
per-class NMS at test time; ubteacher's StandardROIHeadsPseudoLab and its
focal loss). The box head flattens the pooled ROIs channels-last, (7, 7,
C), as the JAX package does, so the JAX tree's fc1 rows load unchanged.

``multilevel_roi_align`` pools each box from its assigned pyramid level in
one call (``ops/roi_align.py:roi_align_levels``, kernel D on the card, its
backward kernel when the features require grad). The JAX function pools
every box on every level under a mask and sums the levels; the values are
the same, except that a -0 from the box's own level comes out of the JAX
sum as +0.

Training (``losses``): the gt boxes appended to the proposals, IoU-0.5
matching, ``batch_size_per_image`` proposals sampled at
``positive_fraction`` and compacted to that many rows by a top-k (sampled
first, positives first, random order within), then CrossEntropy or focal
classification and L1 box regression (``smooth_l1`` over the sampled rows
or ``smooth_l1_mean`` over the foreground coordinates).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import apply_deltas, box_area, get_deltas, pairwise_iou
from ...core.instances import Detections
from ...core.matcher import Matcher
from ...core import sampling
from ...ops.roi_align import roi_align_levels
from ..postprocess import fast_rcnn_inference_single
from ..proposal_generator.rpn import _top_k

FPN_STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}


def assign_boxes_to_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                           canonical_box_size: float = 224.0,
                           canonical_level: int = 4) -> torch.Tensor:
    """d2 poolers.assign_boxes_to_levels: floor(canonical + log2(sqrt(area) /
    224)), clipped, relative to ``min_level``; (P, 4) -> (P,) int32."""
    area = box_area(boxes).clamp(min=1e-8)
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_box_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32) - min_level


def multilevel_roi_align(features: Sequence[torch.Tensor], strides: Sequence[int],
                         boxes: torch.Tensor, valid: torch.Tensor, *, output_size: int = 7,
                         sampling_ratio: int = 0, aligned: bool = True,
                         min_level: int = 2) -> torch.Tensor:
    """features: per level (H, W, C) -> (P, C, S, S), each box pooled on its
    assigned level; invalid boxes give zeros."""
    lvl = assign_boxes_to_levels(boxes, min_level, min_level + len(features) - 1)
    return roi_align_levels(features, boxes, valid, lvl, [1.0 / s for s in strides],
                            output_size=(output_size, output_size),
                            sampling_ratio=sampling_ratio, aligned=aligned)


def add_ground_truth_to_proposals(prop_boxes: torch.Tensor, prop_logits: torch.Tensor,
                                  prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
                                  gt_valid: torch.Tensor):
    """detectron2's add_ground_truth_to_proposals: the gt boxes appended as
    proposals with objectness logit(1 - 1e-10)."""
    gt_logit = math.log((1.0 - 1e-10) / 1e-10)
    return (torch.cat([prop_boxes, gt_boxes]),
            torch.cat([prop_logits, torch.full((gt_boxes.shape[0],), gt_logit,
                                               dtype=prop_logits.dtype, device=gt_boxes.device)]),
            torch.cat([prop_valid, gt_valid]))


def label_and_sample_proposals(prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                               gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                               gt_valid: torch.Tensor, matcher: Matcher,
                               generator: torch.Generator, *, batch_size_per_image: int = 512,
                               positive_fraction: float = 0.25, num_classes: int = 20):
    """The sampled set at a fixed batch_size_per_image rows (fewer when
    there are fewer proposals): (boxes, classes with num_classes the
    background, matched gt row, valid, foreground, stats). Draws the
    positives' and negatives' priorities, then the compaction noise."""
    matched, labels = matcher(pairwise_iou(gt_boxes, prop_boxes), gt_valid)
    bg = torch.full_like(matched, num_classes)
    cls = torch.where(labels == 1, gt_classes.long()[matched], bg)
    cls = torch.where(labels == -1, torch.full_like(cls, -1), cls)
    cls = torch.where(gt_valid.any(), cls, bg)
    pos_mask = prop_valid & (cls >= 0) & (cls < num_classes)
    neg_mask = prop_valid & (cls == num_classes)
    pos_keep, neg_keep = sampling.subsample_masks(pos_mask, neg_mask, batch_size_per_image,
                                                  positive_fraction, generator)
    sampled = pos_keep | neg_keep
    # compact to batch_size_per_image rows: sampled first, positives first
    pri = (sampled.float() * 2.0 + pos_keep.float()
           + sampling.uniform(sampled.shape, generator, sampled.device) * 0.5)
    _, idx = _top_k(pri, min(batch_size_per_image, prop_boxes.shape[0]))
    out_valid = sampled[idx]
    out_boxes = torch.where(out_valid[:, None], prop_boxes[idx], torch.zeros_like(prop_boxes[idx]))
    out_cls = torch.where(out_valid, cls[idx], bg[idx])
    fg = out_valid & (out_cls < num_classes)
    stats = {"num_fg": fg.sum(), "num_bg": (out_valid & ~fg).sum()}
    return out_boxes, out_cls, matched[idx], out_valid, fg, stats


def fast_rcnn_losses(scores: torch.Tensor, deltas: torch.Tensor, sampled_boxes: torch.Tensor,
                     gt_classes: torch.Tensor, gt_boxes: torch.Tensor,
                     sampled_valid: torch.Tensor, fg: torch.Tensor, *, num_classes: int,
                     bbox_reg_weights=(10.0, 10.0, 5.0, 5.0), smooth_l1_beta: float = 0.0,
                     box_reg_loss_type: str = "smooth_l1", loss_type: str = "CrossEntropy",
                     focal_gamma: float = 1.5) -> Dict[str, torch.Tensor]:
    """scores (S, K + 1), deltas (S, 4K) or (S, 4), the sampled boxes and
    their classes in [0, K] (K the background), matched gt boxes, validity
    and foreground -> loss_cls (CE, or ubteacher's focal CE x (1 - p)^gamma,
    summed over the sampled rows over their count) and loss_box_reg (L1 of
    the foreground's class column).

    One image's rows: ``n`` and the foreground count of "smooth_l1_mean"
    are that image's counts, as in the JAX package's per-image vmap, and
    the batch's loss is the mean over its images. Under data parallelism
    each rank holds the same number of images, so DDP's mean over the ranks
    of these means is the global batch's mean: no count is all-reduced."""
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    n = torch.clamp(sampled_valid.float().sum(), min=1.0)
    logp = torch.log_softmax(scores.float(), dim=-1)
    ce = -logp.gather(1, gt_classes.long().clamp(0, num_classes)[:, None])[:, 0]
    ce = torch.where(sampled_valid, ce, zero)
    if loss_type == "FocalLoss":
        p = torch.exp(-ce)
        loss_cls = (ce * (1.0 - p) ** focal_gamma).sum() / n
    else:
        loss_cls = ce.sum() / n
    nb = deltas.shape[-1] // 4
    d = deltas.float().reshape(deltas.shape[0], nb, 4)
    col = (torch.zeros_like(gt_classes.long()) if nb == 1
           else gt_classes.long().clamp(0, nb - 1))
    pred = d.gather(1, col[:, None, None].expand(-1, 1, 4))[:, 0]
    diff = (pred - get_deltas(sampled_boxes, gt_boxes, bbox_reg_weights)).abs()
    if smooth_l1_beta > 0:
        l1 = torch.where(diff < smooth_l1_beta, 0.5 * diff * diff / smooth_l1_beta,
                         diff - 0.5 * smooth_l1_beta)
    else:
        l1 = diff
    l1 = torch.where(fg[:, None], l1, zero)
    if box_reg_loss_type == "smooth_l1_mean":
        loss_box = l1.sum() / torch.clamp(fg.float().sum() * 4.0, min=1.0)
    else:
        loss_box = l1.sum() / n
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


class FastRCNNConvFCHead(nn.Module):
    """NUM_CONV 3x3 convs then NUM_FC fcs (voc_baseline: 0 convs, 2 fcs of
    1024), on channels-last pooled ROIs (P, S, S, C)."""

    def __init__(self, in_channels: int, resolution: int, num_conv: int = 0,
                 conv_dim: int = 256, num_fc: int = 2, fc_dim: int = 1024, device=None):
        super().__init__()
        self.num_conv, self.num_fc = num_conv, num_fc
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", nn.Conv2d(c, conv_dim, 3, padding=1, device=device))
            c = conv_dim
        d = c * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(d, fc_dim, device=device))
            d = fc_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_conv:
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_conv):
                x = F.relu(getattr(self, f"conv{i + 1}")(x))
            x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    """cls_score (K + 1) and bbox_pred (4 or 4K) linear heads."""

    def __init__(self, in_dim: int, num_classes: int = 20, cls_agnostic_bbox_reg: bool = False,
                 device=None):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_classes + 1, device=device)
        nb = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = nn.Linear(in_dim, nb * 4, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class StandardROIHeads(nn.Module):
    def __init__(self, in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 strides: Sequence[int] = (4, 8, 16, 32), in_channels: int = 256,
                 num_classes: int = 20, batch_size_per_image: int = 512,
                 positive_fraction: float = 0.25, iou_thresholds: Sequence[float] = (0.5,),
                 iou_labels: Sequence[int] = (0, 1), proposal_append_gt: bool = True,
                 pooler_resolution: int = 7,
                 pooler_sampling_ratio: int = 0, pooler_aligned: bool = True, num_conv: int = 0,
                 conv_dim: int = 256, num_fc: int = 2, fc_dim: int = 1024,
                 cls_agnostic_bbox_reg: bool = False,
                 bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
                 smooth_l1_beta: float = 0.0, box_reg_loss_type: str = "smooth_l1",
                 loss_type: str = "CrossEntropy",
                 score_thresh_test: float = 0.05, nms_thresh_test: float = 0.5,
                 detections_per_image: int = 100, device=None):
        super().__init__()
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.matcher = Matcher(list(iou_thresholds), list(iou_labels))
        self.proposal_append_gt = proposal_append_gt
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_type = box_reg_loss_type
        self.loss_type = loss_type
        self.pooler_resolution = pooler_resolution
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.pooler_aligned = pooler_aligned
        self.bbox_reg_weights = tuple(bbox_reg_weights)
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.detections_per_image = detections_per_image
        self.box_head = FastRCNNConvFCHead(in_channels, pooler_resolution, num_conv, conv_dim,
                                           num_fc, fc_dim, device=device)
        head_dim = fc_dim if num_fc else (conv_dim if num_conv else in_channels) * \
            pooler_resolution ** 2
        self.box_predictor = FastRCNNOutputLayers(head_dim, num_classes, cls_agnostic_bbox_reg,
                                                  device=device)

    def _pool_and_predict(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor,
                          valid: torch.Tensor):
        """features: per level (H, W, C) -> class logits (P, K + 1) and
        deltas (P, 4K). Profiler ranges ``roi_align`` and ``box_head``."""
        with record_function("roi_align"):
            pooled = multilevel_roi_align(
                [features[f] for f in self.in_features], self.strides, boxes, valid,
                output_size=self.pooler_resolution, sampling_ratio=self.pooler_sampling_ratio,
                aligned=self.pooler_aligned)
        with record_function("box_head"):
            return self.box_predictor(self.box_head(pooled.permute(0, 2, 3, 1)))

    def losses(self, features: Dict[str, torch.Tensor], prop_boxes: torch.Tensor,
               prop_logits: torch.Tensor, prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_valid: torch.Tensor, generator: torch.Generator, *,
               append_gt: bool = True) -> Dict[str, torch.Tensor]:
        """One image: features per level (H, W, C), detached proposals, the
        gt -> loss_cls, loss_box_reg. Profiler ranges ``losses`` (sampling,
        then the losses), ``roi_align`` and ``box_head``."""
        with record_function("losses"):
            if self.proposal_append_gt and append_gt:
                prop_boxes, prop_logits, prop_valid = add_ground_truth_to_proposals(
                    prop_boxes, prop_logits, prop_valid, gt_boxes, gt_valid)
            s_boxes, s_cls, s_match, s_valid, fg, _ = label_and_sample_proposals(
                prop_boxes, prop_valid, gt_boxes, gt_classes, gt_valid, self.matcher, generator,
                batch_size_per_image=self.batch_size_per_image,
                positive_fraction=self.positive_fraction, num_classes=self.num_classes)
        scores, deltas = self._pool_and_predict(features, s_boxes, s_valid)
        with record_function("losses"):
            return fast_rcnn_losses(
                scores, deltas, s_boxes, s_cls, gt_boxes[s_match], s_valid, fg,
                num_classes=self.num_classes, bbox_reg_weights=self.bbox_reg_weights,
                smooth_l1_beta=self.smooth_l1_beta, box_reg_loss_type=self.box_reg_loss_type,
                loss_type=self.loss_type)

    def predict(self, features: Dict[str, torch.Tensor], prop_boxes: torch.Tensor,
                prop_valid: torch.Tensor, image_hw: torch.Tensor, *,
                score_thresh: float = None) -> Tuple[Detections, torch.Tensor, torch.Tensor]:
        """Returns (Detections, probs (P, K + 1) f32, pred_boxes (P, 4K) f32).
        Profiler range ``nms_topk`` around the post-processing."""
        scores, deltas = self._pool_and_predict(features, prop_boxes, prop_valid)
        probs = torch.softmax(scores.float(), dim=-1)
        pred_boxes = apply_deltas(deltas.float(), prop_boxes.float(), self.bbox_reg_weights)
        with record_function("nms_topk"):
            det = fast_rcnn_inference_single(
                pred_boxes, probs, prop_valid, image_hw,
                score_thresh=self.score_thresh_test if score_thresh is None else score_thresh,
                nms_thresh=self.nms_thresh_test, topk=self.detections_per_image)
        return det, probs, pred_boxes

    @classmethod
    def from_cfg(cls, cfg, device=None) -> "StandardROIHeads":
        in_features = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES)
        head = cfg.MODEL.ROI_BOX_HEAD
        if head.POOLER_TYPE not in ("ROIAlignV2", "ROIAlign"):
            raise ValueError(f"StandardROIHeads: pooler {head.POOLER_TYPE!r} is not ported")
        return cls(in_features=in_features, strides=tuple(FPN_STRIDES[f] for f in in_features),
                   in_channels=cfg.MODEL.FPN.OUT_CHANNELS,
                   num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                   batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
                   positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
                   iou_thresholds=tuple(cfg.MODEL.ROI_HEADS.IOU_THRESHOLDS),
                   iou_labels=tuple(cfg.MODEL.ROI_HEADS.IOU_LABELS),
                   proposal_append_gt=cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT,
                   pooler_resolution=head.POOLER_RESOLUTION,
                   pooler_sampling_ratio=head.POOLER_SAMPLING_RATIO,
                   pooler_aligned=head.POOLER_TYPE == "ROIAlignV2", num_conv=head.NUM_CONV,
                   conv_dim=head.CONV_DIM, num_fc=head.NUM_FC, fc_dim=head.FC_DIM,
                   cls_agnostic_bbox_reg=head.CLS_AGNOSTIC_BBOX_REG,
                   bbox_reg_weights=tuple(head.BBOX_REG_WEIGHTS),
                   smooth_l1_beta=head.SMOOTH_L1_BETA, box_reg_loss_type=head.BBOX_REG_LOSS_TYPE,
                   loss_type=cfg.MODEL.ROI_HEADS.LOSS,
                   score_thresh_test=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                   nms_thresh_test=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                   detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE, device=device)
