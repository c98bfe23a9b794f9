"""Faster R-CNN meta-architecture (stages 2-3).

Counterpart of ``sos_wsod_tpu/models/meta/rcnn.py`` (detectron2
GeneralizedRCNN and ubteacher's TwoStagePseudoLabGeneralizedRCNN): ResNet-FPN
-> RPN -> StandardROIHeads. ``forward(batch, branch)`` serves "inference"
and "unsup_data_weak" (the teacher's pseudo-labelling pass), both
``predict`` on one image, and "supervised" and "val_loss" (the latter
without the gt appended to the proposals), both ``losses`` on a batch.

``losses`` runs the backbone on the whole batch as one NCHW tensor (FrozenBN
keeps no batch statistics, so each image's features are its own), then the
RPN and ROI heads one image at a time, and returns the mean over the images
of each loss, as ``jax.vmap`` and a mean over the batch give them in the JAX
package's supervised step. Each image draws, in order, the RPN's sampling
priorities, then the ROI heads' (``core/sampling.py``).
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
        """(H, W, 3) or (B, H, W, 3) BGR raw -> (B, 3, H, W) normalized,
        channels_last memory (B = 1 for one image). As in the JAX package,
        the whole canvas is normalized, padding too."""
        mean = torch.tensor(self.pixel_mean, dtype=torch.float32, device=image.device)
        std = torch.tensor(self.pixel_std, dtype=torch.float32, device=image.device)
        x = (image.float() - mean) / std
        x = x[None] if x.dim() == 3 else x
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def _features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(H, W, 3) or (B, H, W, 3) -> p2..p6, NCHW (B, C, h, w) in
        channels_last memory."""
        return self.backbone(self._normalize(image))

    def losses(self, batch: Dict[str, torch.Tensor], generator: torch.Generator, *,
               compute_proposal_loss: bool = True, append_gt: bool = True
               ) -> Dict[str, torch.Tensor]:
        """A batch of B images on one canvas: image (B, H, W, 3), image_hw
        (B, 2), gt_boxes (B, G, 4), gt_classes (B, G), gt_valid (B, G) ->
        the mean over the images of loss_cls, loss_box_reg and (with
        ``compute_proposal_loss``) loss_rpn_cls, loss_rpn_loc. Profiler
        ranges ``backbone``, ``rpn``, ``losses``, ``roi_align`` and
        ``box_head``."""
        with record_function("backbone"):
            feats = self._features(batch["image"])
        per_image = []
        for i in range(batch["image"].shape[0]):
            with record_function("rpn"):
                (pb, pl, pv), head_outputs = self.proposal_generator.proposals(
                    {k: v[i:i + 1] for k, v in feats.items()}, batch["image_hw"][i], train=True)
            gt = (batch["gt_boxes"][i], batch["gt_classes"][i], batch["gt_valid"][i])
            rpn_loss = {}
            if compute_proposal_loss:
                with record_function("losses"):
                    rpn_loss = self.proposal_generator.losses(head_outputs, gt[0], gt[2],
                                                              generator)
            hwc = {k: v[i].permute(1, 2, 0) for k, v in feats.items()}
            roi_loss = self.roi_heads.losses(hwc, pb, pl, pv, *gt, generator,
                                             append_gt=append_gt)
            per_image.append({**roi_loss, **rpn_loss})
        return {k: torch.stack([m[k] for m in per_image]).mean() for k in per_image[0]}

    def predict(self, batch: Dict[str, torch.Tensor], *, score_thresh: float = None
                ) -> Tuple[Detections, tuple, tuple]:
        """One image: batch["image"] (H, W, 3) BGR raw (padded), batch["image_hw"]
        (2,) its resized extent. Returns (Detections, (proposal boxes, logits,
        valid), (probs (P, K + 1), pred_boxes (P, 4K))). Profiler ranges
        ``backbone``, ``rpn``, ``roi_align``, ``box_head`` and ``nms_topk``."""
        with record_function("backbone"):
            feats = self._features(batch["image"])
        with record_function("rpn"):
            (pb, pl, pv), _ = self.proposal_generator.proposals(feats, batch["image_hw"])
        hwc = {k: v.permute(0, 2, 3, 1)[0] for k, v in feats.items()}
        det, probs, pred_boxes = self.roi_heads.predict(hwc, pb, pv, batch["image_hw"],
                                                        score_thresh=score_thresh)
        return det, (pb, pl, pv), (probs, pred_boxes)

    def forward(self, batch: Dict[str, torch.Tensor], branch: str = "inference",
                generator: torch.Generator = None):
        """ubteacher's branch dispatch (rcnn.py:30-105): "supervised" and
        "val_loss" take a batch and the generator of the sampling draws,
        "inference" and "unsup_data_weak" one image."""
        if branch == "supervised":
            return self.losses(batch, generator)
        if branch == "val_loss":
            return self.losses(batch, generator, append_gt=False)
        if branch in ("inference", "unsup_data_weak"):
            return self.predict(batch)
        raise ValueError(f"Unknown branch {branch}")

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
