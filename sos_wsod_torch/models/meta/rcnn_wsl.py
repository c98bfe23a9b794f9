"""MultiInputRCNN meta-architecture, stage-1 inference.

Counterpart of ``sos_wsod_tpu/models/meta/rcnn_wsl.py`` (``_normalize``,
``_pool`` with the ROIPool pooler, ``predict`` and ``from_cfg``). Inference is
a plain single-image path: VGG16 -> ROIPool x (objectness + 1) -> DAN -> K=4
branch ensemble -> masked per-class NMS. The 4-view training loss is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.instances import Detections
from ...ops.roi_pool import roi_pool
from ..backbones.vgg import VGG16
from ..heads.oicr_plus import OICRPlusHead
from ..postprocess import fast_rcnn_inference_single


class MultiInputRCNN(nn.Module):
    def __init__(
        self,
        num_classes: int = 20,
        pixel_mean: Sequence[float] = (103.939, 116.779, 123.68),  # BGR
        pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        conv5_dilation: int = 2,
        pooler_resolution: int = 7,
        refine_k: int = 4,
        refine_reg: Sequence[bool] = (True, True, True, True),
        dan_dims: Sequence[int] = (4096, 4096),
        dan_dropout: float = 0.5,
        score_thresh: float = 1e-6,
        nms_thresh: float = 0.3,
        detections_per_image: int = 100,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.backbone = VGG16(conv5_dilation=conv5_dilation, device=device)
        self.roi_heads = OICRPlusHead(
            512 * pooler_resolution ** 2, num_classes=num_classes, refine_k=refine_k,
            refine_reg=tuple(refine_reg), dan_dims=tuple(dan_dims),
            dan_dropout=dan_dropout, device=device)
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.stride = 8 if conv5_dilation == 2 else 16
        self.pooler_resolution = pooler_resolution
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_image = detections_per_image
        # autocast dtype for inference (TPU.COMPUTE_DTYPE in the config)
        self.compute_dtype = compute_dtype

    def _normalize(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR raw -> (1, 3, H, W) normalized, channels_last memory."""
        mean = torch.tensor(self.pixel_mean, dtype=torch.float32, device=image.device)
        std = torch.tensor(self.pixel_std, dtype=torch.float32, device=image.device)
        x = (image.float() - mean) / std
        return x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)

    def _pool(self, feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
              row_scale: torch.Tensor) -> torch.Tensor:
        """feat (H, W, C) -> (P, 7, 7, C), objectness weighting fused."""
        res = (self.pooler_resolution, self.pooler_resolution)
        return roi_pool(feat, boxes, valid, row_scale,
                        spatial_scale=1.0 / self.stride, output_size=res)

    def backbone_features(self, image: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR raw, (2,) valid extent -> plain5 as (H/8, W/8, 512)."""
        plain5 = self.backbone(self._normalize(image), valid_hw[None])
        return plain5.permute(0, 2, 3, 1)[0]

    def predict(self, batch: Dict[str, torch.Tensor]) -> Tuple[Detections, torch.Tensor, torch.Tensor]:
        """Single-image inference. batch:
          image: (H, W, 3) BGR raw (padded); valid_hw: (2,) int
          boxes/objectness/prop_valid: (P, 4)/(P,)/(P,)
          image_hw: (2,) the true resized input size (for clipping)
        Returns (Detections, all_scores (P, K+1), all_boxes (P, K*4)).
        Each layer runs in a profiler range of its name (``backbone``,
        ``roi_pool``, ``box_head``, ``nms_topk``)."""
        with record_function("backbone"):
            feat = self.backbone_features(batch["image"], batch["valid_hw"])
        with record_function("roi_pool"):
            obn = batch["objectness"].float() + 1.0
            pooled = self._pool(feat, batch["boxes"], batch["prop_valid"], obn)
        with record_function("box_head"):
            scores, pred_boxes = self.roi_heads.predict(pooled, batch["boxes"])
        with record_function("nms_topk"):
            det = fast_rcnn_inference_single(
                pred_boxes, scores, batch["prop_valid"], batch["image_hw"],
                score_thresh=self.score_thresh, nms_thresh=self.nms_thresh,
                topk=self.detections_per_image)
        return det, scores, pred_boxes

    @classmethod
    def from_cfg(cls, cfg, device=None, **overrides) -> "MultiInputRCNN":
        if cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE != "ROIPool":
            raise ValueError("sos_wsod_torch MultiInputRCNN supports the ROIPool pooler "
                             f"only, got {cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE!r}")
        kw = dict(
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            conv5_dilation=cfg.MODEL.VGG.CONV5_DILATION,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            refine_k=cfg.WSL.REFINE_NUM,
            refine_reg=tuple(cfg.WSL.REFINE_REG),
            dan_dims=tuple(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM),
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            compute_dtype=(torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32),
        )
        kw.update(overrides)
        return cls(device=device, **kw)
