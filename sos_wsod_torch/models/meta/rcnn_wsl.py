"""MultiInputRCNN meta-architecture: the stage-1 WSOD model.

Counterpart of ``sos_wsod_tpu/models/meta/rcnn_wsl.py`` (``_normalize``,
``_pool`` with the ROIPool pooler, ``loss``, ``predict`` and ``from_cfg``).
Training (``loss``) takes 4 synchronized views of one image, two scales x
{identity, hflip}: each scale runs through VGG16 as one batch of 2, each
view is pooled by ROIPool x (objectness + 1), and the OICR+ head computes the
MIL and refinement losses. Inference (``predict``) is a plain single-image
path: VGG16 -> ROIPool -> DAN -> K=4 branch ensemble -> masked per-class NMS.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.instances import Detections
from ...ops.roi_pool import roi_pool
from ..backbones.vgg import VGG16
from ..heads.oicr_plus import OICRPlusHead
from ..postprocess import fast_rcnn_inference_single


def normalize_images(images: torch.Tensor, pixel_mean: Sequence[float],
                     pixel_std: Sequence[float]) -> torch.Tensor:
    """(N, H, W, 3) BGR raw -> (N, 3, H, W) normalized, channels_last memory."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=images.device)
    x = (images.float() - mean) / std
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class MultiInputRCNN(nn.Module):
    def __init__(
        self,
        num_classes: int = 20,
        pixel_mean: Sequence[float] = (103.939, 116.779, 123.68),  # BGR
        pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        conv5_dilation: int = 2,
        freeze_at: int = 2,
        pooler_resolution: int = 7,
        refine_k: int = 4,
        refine_reg: Sequence[bool] = (True, True, True, True),
        refine_mist: bool = True,
        mist_type: str = "nms",
        mist_p: float = 0.10,
        mist_thre: float = 0.05,
        bbox_update: bool = False,
        mean_loss: bool = True,
        seed_cap: int = 1024,
        dan_dims: Sequence[int] = (4096, 4096),
        dan_dropout: float = 0.5,
        score_thresh: float = 1e-6,
        nms_thresh: float = 0.3,
        detections_per_image: int = 100,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.backbone = VGG16(conv5_dilation=conv5_dilation, freeze_at=freeze_at, device=device)
        self.roi_heads = OICRPlusHead(
            512 * pooler_resolution ** 2, num_classes=num_classes, refine_k=refine_k,
            refine_reg=tuple(refine_reg), refine_mist=refine_mist, mist_type=mist_type,
            mist_p=mist_p, mist_thre=mist_thre, bbox_update=bbox_update, mean_loss=mean_loss,
            seed_cap=seed_cap, dan_dims=tuple(dan_dims), dan_dropout=dan_dropout,
            device=device)
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.stride = 8 if conv5_dilation == 2 else 16
        self.pooler_resolution = pooler_resolution
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_image = detections_per_image
        # autocast dtype (TPU.COMPUTE_DTYPE in the config)
        self.compute_dtype = compute_dtype

    def _normalize(self, images: torch.Tensor) -> torch.Tensor:
        return normalize_images(images, self.pixel_mean, self.pixel_std)

    def _pool(self, feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
              row_scale: torch.Tensor) -> torch.Tensor:
        """feat (H, W, C) -> (P, 7, 7, C), objectness weighting fused."""
        res = (self.pooler_resolution, self.pooler_resolution)
        return roi_pool(feat, boxes, valid, row_scale,
                        spatial_scale=1.0 / self.stride, output_size=res)

    def backbone_features(self, image: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR raw, (2,) valid extent -> plain5 as (H/8, W/8, 512)."""
        plain5 = self.backbone(self._normalize(image[None]), valid_hw[None])
        return plain5.permute(0, 2, 3, 1)[0]

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One image, 4 views. batch:
          images_s1, images_s2: (2, H_s, W_s, 3) BGR raw [view, hflipped view]
          valid_hw_s1, valid_hw_s2: (2, 2) true extents inside the canvas
          boxes: (4, P, 4) per-view proposals [s1, s1 flip, s2, s2 flip]
          objectness: (P,); prop_valid: (P,) bool; gt_classes_oh: (K,)
        Returns the f32 loss terms and metrics of ``OICRPlusHead.losses``;
        dropout draws from ``generator``. Profiler ranges: ``backbone``,
        ``roi_pool`` and the head's."""
        feats = []
        with record_function("backbone"):
            for s in ("s1", "s2"):
                f = self.backbone(self._normalize(batch[f"images_{s}"]), batch[f"valid_hw_{s}"])
                f = f.permute(0, 2, 3, 1)
                feats += [f[0], f[1]]
        with record_function("roi_pool"):
            obn = batch["objectness"].float() + 1.0
            pooled = torch.stack([self._pool(feats[i], batch["boxes"][i], batch["prop_valid"], obn)
                                  for i in range(4)])
        return self.roi_heads.losses(pooled, batch["boxes"], batch["prop_valid"],
                                     batch["gt_classes_oh"], generator)

    def predict_scores(self, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``predict`` up to the box head: (all_scores (P, K+1), all_boxes
        (P, K*4)), without the NMS (test-time augmentation's AVG merges
        these over the views). Profiler ranges ``backbone``, ``roi_pool``
        and ``box_head``."""
        with record_function("backbone"):
            feat = self.backbone_features(batch["image"], batch["valid_hw"])
        with record_function("roi_pool"):
            obn = batch["objectness"].float() + 1.0
            pooled = self._pool(feat, batch["boxes"], batch["prop_valid"], obn)
        with record_function("box_head"):
            return self.roi_heads.predict(pooled, batch["boxes"])

    def predict(self, batch: Dict[str, torch.Tensor]) -> Tuple[Detections, torch.Tensor, torch.Tensor]:
        """Single-image inference. batch:
          image: (H, W, 3) BGR raw (padded); valid_hw: (2,) int
          boxes/objectness/prop_valid: (P, 4)/(P,)/(P,)
          image_hw: (2,) the true resized input size (for clipping)
        Returns (Detections, all_scores (P, K+1), all_boxes (P, K*4)).
        Each layer runs in a profiler range of its name (``backbone``,
        ``roi_pool``, ``box_head``, ``nms_topk``)."""
        scores, pred_boxes = self.predict_scores(batch)
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
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            refine_k=cfg.WSL.REFINE_NUM,
            refine_reg=tuple(cfg.WSL.REFINE_REG),
            refine_mist=cfg.WSL.REFINE_MIST,
            mist_type=cfg.WSL.MIST_TYPE,
            mist_p=cfg.WSL.MIST_P,
            mist_thre=cfg.WSL.MIST_THRE,
            bbox_update=cfg.OICRPLUS.BBOX_UPDATE,
            mean_loss=cfg.WSL.MEAN_LOSS,
            seed_cap=cfg.TPU.PGT_SEED_CAPACITY,
            dan_dims=tuple(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM),
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            compute_dtype=(torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32),
        )
        kw.update(overrides)
        return cls(device=device, **kw)
