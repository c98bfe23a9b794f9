"""Standard (Faster R-CNN) ROI heads, inference branch.

Counterpart of ``sos_wsod_tpu/models/roi_heads/standard.py`` (detectron2
StandardROIHeads + FastRCNNConvFCHead + FastRCNNOutputLayers, softmax and
per-class NMS at test time). The box head flattens the pooled ROIs
channels-last, (7, 7, C), as the JAX package does, so the JAX tree's fc1
rows load unchanged.

``multilevel_roi_align`` pools each box from its assigned pyramid level in
one call (``ops/roi_align.py:roi_align_levels``, kernel D on the card). The
JAX function pools every box on every level under a mask and sums the
levels; the values are the same, except that a -0 from the box's own level
comes out of the JAX sum as +0. The losses, proposal sampling and
ground-truth appending belong to the stage-2/3 training slice and are not
ported.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import apply_deltas, box_area
from ...core.instances import Detections
from ...ops.roi_align import roi_align_levels
from ..postprocess import fast_rcnn_inference_single

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
                 num_classes: int = 20, pooler_resolution: int = 7,
                 pooler_sampling_ratio: int = 0, pooler_aligned: bool = True, num_conv: int = 0,
                 conv_dim: int = 256, num_fc: int = 2, fc_dim: int = 1024,
                 cls_agnostic_bbox_reg: bool = False,
                 bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
                 score_thresh_test: float = 0.05, nms_thresh_test: float = 0.5,
                 detections_per_image: int = 100, device=None):
        super().__init__()
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
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
                   pooler_resolution=head.POOLER_RESOLUTION,
                   pooler_sampling_ratio=head.POOLER_SAMPLING_RATIO,
                   pooler_aligned=head.POOLER_TYPE == "ROIAlignV2", num_conv=head.NUM_CONV,
                   conv_dim=head.CONV_DIM, num_fc=head.NUM_FC, fc_dim=head.FC_DIM,
                   cls_agnostic_bbox_reg=head.CLS_AGNOSTIC_BBOX_REG,
                   bbox_reg_weights=tuple(head.BBOX_REG_WEIGHTS),
                   score_thresh_test=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                   nms_thresh_test=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                   detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE, device=device)
