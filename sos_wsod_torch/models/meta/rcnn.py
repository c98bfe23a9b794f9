"""Faster R-CNN meta-architecture (stages 2-3), inference branches.

Counterpart of ``sos_wsod_tpu/models/meta/rcnn.py`` (detectron2
GeneralizedRCNN and ubteacher's TwoStagePseudoLabGeneralizedRCNN): ResNet-FPN
-> RPN -> StandardROIHeads on one image. ``forward(batch, branch)`` serves
"inference" and "unsup_data_weak" (the teacher's pseudo-labelling pass),
both ``predict``. The training branches, "supervised" and "val_loss", belong
to the stage-2/3 training slice and raise.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.instances import Detections
from ..backbones.fpn import ResNetFPN
from ..proposal_generator.rpn import RPN
from ..roi_heads.standard import StandardROIHeads

_TRAINING = ("stage-2/3 training is not ported yet; it is the next slice (ROADMAP Queue 1 "
             "item 4: RPN and ROI losses, proposal sampling, the ROIAlign backward kernel)")


class GeneralizedRCNN(nn.Module):
    def __init__(self, proposal_generator: RPN, roi_heads: StandardROIHeads,
                 pixel_mean: Sequence[float] = (103.530, 116.280, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0), depth: int = 50,
                 freeze_at: int = 2, fpn_out_channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.backbone = ResNetFPN(depth=depth, freeze_at=freeze_at,
                                  out_channels=fpn_out_channels, device=device)
        self.proposal_generator = proposal_generator
        self.roi_heads = roi_heads
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        # autocast dtype (TPU.COMPUTE_DTYPE in the config)
        self.compute_dtype = compute_dtype

    def _normalize(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR raw -> (1, 3, H, W) normalized, channels_last memory.
        As in the JAX package, the whole canvas is normalized, padding too."""
        mean = torch.tensor(self.pixel_mean, dtype=torch.float32, device=image.device)
        std = torch.tensor(self.pixel_std, dtype=torch.float32, device=image.device)
        x = (image.float() - mean) / std
        return x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)

    def _features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(H, W, 3) -> p2..p6, NCHW (1, C, h, w) in channels_last memory."""
        return self.backbone(self._normalize(image))

    def predict(self, batch: Dict[str, torch.Tensor], *, score_thresh: float = None
                ) -> Tuple[Detections, tuple, tuple]:
        """One image: batch["image"] (H, W, 3) BGR raw (padded), batch["image_hw"]
        (2,) its resized extent. Returns (Detections, (proposal boxes, logits,
        valid), (probs (P, K + 1), pred_boxes (P, 4K))). Profiler ranges
        ``backbone``, ``rpn``, ``roi_align``, ``box_head`` and ``nms_topk``."""
        with record_function("backbone"):
            feats = self._features(batch["image"])
        with record_function("rpn"):
            pb, pl, pv = self.proposal_generator(feats, batch["image_hw"])
        hwc = {k: v.permute(0, 2, 3, 1)[0] for k, v in feats.items()}
        det, probs, pred_boxes = self.roi_heads.predict(hwc, pb, pv, batch["image_hw"],
                                                        score_thresh=score_thresh)
        return det, (pb, pl, pv), (probs, pred_boxes)

    def forward(self, batch: Dict[str, torch.Tensor], branch: str = "inference"):
        """ubteacher's branch dispatch (rcnn.py:30-105)."""
        if branch in ("inference", "unsup_data_weak"):
            return self.predict(batch)
        if branch in ("supervised", "val_loss"):
            raise NotImplementedError(f"branch {branch!r}: {_TRAINING}")
        raise ValueError(f"Unknown branch {branch}")

    def losses(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    @classmethod
    def from_cfg(cls, cfg, device=None) -> "GeneralizedRCNN":
        if cfg.MODEL.META_ARCHITECTURE not in ("GeneralizedRCNN",
                                               "TwoStagePseudoLabGeneralizedRCNN"):
            raise ValueError(f"GeneralizedRCNN.from_cfg: META_ARCHITECTURE "
                             f"{cfg.MODEL.META_ARCHITECTURE!r}")
        return cls(RPN.from_cfg(cfg, device=device), StandardROIHeads.from_cfg(cfg, device=device),
                   pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD),
                   depth=cfg.MODEL.RESNETS.DEPTH, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
                   fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
                   compute_dtype=(torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                                  else torch.float32),
                   device=device)


# ubteacher alias: the branch-gated model is GeneralizedRCNN here
TwoStagePseudoLabGeneralizedRCNN = GeneralizedRCNN
