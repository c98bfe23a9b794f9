"""GeneralizedRCNNWSL: the single-view WSOD meta-architecture.

Counterpart of ``sos_wsod_tpu/models/meta/rcnn_wsl_single.py`` (the
reference's GeneralizedRCNNWSL): a backbone on one image (VGG16 with dilated
conv5, or WS-ResNet; stride 8, or 16 when undilated), its precomputed
proposals, a pooler, and one of the WSOD ROI heads: WSDDN, OICR, PCL, CMIL,
ContextLocNet, CSC or WSJDS. The ROIPool pooler (kernel A) and the ROIAlign /
ROIAlignV2 poolers (kernels D and D bwd) feed every head but ContextLocNet,
which takes the ROILoopPool pooler (kernel E): its [box; frame; context]
rows. ROIPool and ROILoopPool fuse the objectness weighting (objectness + 1)
that the JAX heads apply after the pool; the scale is at least 1 and a max
pool picks one cell, so the two orders give the same values. ROIAlign's
bilinear sum does not commute with the rounding to bf16, so its output is
scaled after the pool, as the JAX head does.

The CSC and WSJDS heads' losses take class peak gradient (CPG) maps of the
image: ``compute_cpgs`` (the gradient of each active class's score with
respect to the image, through the whole model, frozen stages included as in
the reference) before the loss, with the same dropout masks. The WSJDS head
also takes the backbone's map (its ASPP segmentation branch) and the raw
image (the dense CRF of its constraint, ``wsjds_constraint``, which no
config key reaches, as in the JAX package), and its ``predict`` returns the
class masks too.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.instances import Detections
from ...ops.roi_align import roi_align
from ...ops.roi_loop_pool import roi_loop_pool
from ...ops.roi_pool import roi_pool
from ..backbones.resnet_ws import WSResNet
from ..backbones.vgg import VGG16
from ..heads.cmil import CMILROIHead
from ..heads.contextlocnet import ContextLocNetROIHead
from ..heads.csc import CSCROIHead, compute_cpg
from ..heads.pcl import PCLROIHead
from ..heads.single_view import OICRROIHead, WSDDNROIHead
from ..heads.wsddn import mil_image_scores
from ..heads.wsjds import WSJDSROIHead
from ..postprocess import fast_rcnn_inference_single
from .rcnn_wsl import MultiInputRCNN, normalize_images

# the reference's ROI_HEADS.NAME -> head
HEAD_NAME_MAP = {
    "WSDDNROIHeads": "WSDDN",
    "OICRROIHeads": "OICR",
    "PCLROIHeads": "PCL",
    "CMILROIHeads": "CMIL",
    "ContextLocNetROIHeads": "ContextLocNet",
    "CSCROIHeads": "CSC",
    "WSJDSROIHeads": "WSJDS",
}
POOLERS = ("ROIPool", "ROILoopPool", "ROIAlign", "ROIAlignV2")


class GeneralizedRCNNWSL(nn.Module):
    def __init__(
        self,
        num_classes: int = 20,
        head: str = "WSDDN",
        backbone_name: str = "vgg16",
        resnet_depth: int = 50,
        pixel_mean: Sequence[float] = (103.939, 116.779, 123.68),  # BGR
        pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
        conv5_dilation: int = 2,
        freeze_at: int = 2,
        pooler_type: str = "ROIPool",
        pooler_resolution: int = 7,
        refine_k: int = 3,
        refine_reg: Sequence[bool] = (False, False, False),
        mean_loss: bool = True,
        dan_dims: Sequence[int] = (4096, 4096),
        dan_dropout: float = 0.5,
        score_thresh: float = 1e-6,
        nms_thresh: float = 0.3,
        detections_per_image: int = 100,
        size_epoch: int = 5000,
        max_iter: int = 200000,
        csc_tau: float = 0.7,
        csc_max_iter: int = 35000,
        wsjds_constraint: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if head not in HEAD_NAME_MAP.values():
            raise ValueError(f"Unknown WSL head {head!r}")
        if pooler_type not in POOLERS:
            raise ValueError(f"Unsupported pooler {pooler_type!r}")
        if (head == "ContextLocNet") != (pooler_type == "ROILoopPool"):
            raise ValueError("ContextLocNet takes the ROILoopPool pooler and the other heads "
                             f"ROIPool or ROIAlign; got {head} with {pooler_type}")
        if backbone_name == "vgg16":
            self.backbone = VGG16(conv5_dilation=conv5_dilation, freeze_at=freeze_at,
                                  device=device)
        elif backbone_name == "ws_resnet":
            self.backbone = WSResNet(depth=resnet_depth, freeze_at=freeze_at,
                                     res5_dilation=conv5_dilation, device=device)
        else:
            raise ValueError(f"Unknown WSL backbone {backbone_name!r}")
        in_features = self.backbone.out_channels * pooler_resolution ** 2
        common = dict(num_classes=num_classes, mean_loss=mean_loss, dan_dims=tuple(dan_dims),
                      dan_dropout=dan_dropout, device=device)
        if head == "WSDDN":
            self.roi_heads = WSDDNROIHead(in_features, **common)
        elif head == "OICR":
            self.roi_heads = OICRROIHead(in_features, refine_k=refine_k,
                                         refine_reg=tuple(refine_reg), **common)
        elif head == "PCL":
            self.roi_heads = PCLROIHead(in_features, refine_k=refine_k, **common)
        elif head == "CMIL":
            self.roi_heads = CMILROIHead(in_features, refine_k=refine_k, size_epoch=size_epoch,
                                         max_iter=max_iter, **common)
        elif head == "CSC":
            self.roi_heads = CSCROIHead(in_features, **common)
        elif head == "WSJDS":
            self.roi_heads = WSJDSROIHead(in_features, self.backbone.out_channels, tau=csc_tau,
                                          constraint=wsjds_constraint, **common)
        else:
            self.roi_heads = ContextLocNetROIHead(in_features, **common)
        self.backbone_name = backbone_name
        self.head = head
        self.pooler_type = pooler_type
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.stride = 8 if conv5_dilation == 2 else 16
        self.pooler_resolution = pooler_resolution
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_image = detections_per_image
        self.compute_dtype = compute_dtype
        self.csc_tau = csc_tau
        self.csc_max_iter = csc_max_iter

    @property
    def uses_iter(self) -> bool:
        """Whether ``loss`` reads the training step (CMIL's lambda, the
        CSC_MAX_ITER switch of CSC and WSJDS)."""
        return self.head in ("CMIL", "CSC", "WSJDS")

    @property
    def uses_cpgs(self) -> bool:
        """Whether ``loss`` takes the CPG maps of ``compute_cpgs``."""
        return self.head in ("CSC", "WSJDS")

    def backbone_features(self, image: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR raw, (2,) valid extent -> the last stage's map as
        (H/s, W/s, C): VGG16's plain5 with the padding beyond the valid
        extent zeroed, WS-ResNet's res5 unmasked (as in the JAX package)."""
        x = normalize_images(image[None], self.pixel_mean, self.pixel_std)
        if self.backbone_name == "vgg16":
            feat = self.backbone(x, valid_hw[None])
        else:
            feat = self.backbone(x)["res5"]
        return feat.permute(0, 2, 3, 1)[0]

    def _pool(self, feat: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
              objectness: torch.Tensor) -> torch.Tensor:
        """feat (H, W, C) -> (P, 7, 7, C) with ROIPool and ROIAlign,
        (3P, 7, 7, C) with ROILoopPool, weighted by objectness + 1."""
        res = (self.pooler_resolution, self.pooler_resolution)
        scale = objectness.float() + 1.0
        if self.pooler_type.startswith("ROIAlign"):
            pooled = roi_align(feat, boxes, valid, spatial_scale=1.0 / self.stride,
                               output_size=res, sampling_ratio=0,
                               aligned=self.pooler_type == "ROIAlignV2")
            # (P, C, 7, 7), on the card a view of a (P, 7, 7, C) tensor
            return (pooled * scale.to(pooled.dtype)[:, None, None, None]).permute(0, 2, 3, 1)
        pool = roi_pool if self.pooler_type == "ROIPool" else roi_loop_pool
        return pool(feat, boxes, valid, scale, spatial_scale=1.0 / self.stride, output_size=res)

    def _pooled(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the backbone's (H/s, W/s, C) map, the pooled ROIs)."""
        with record_function("backbone"):
            feat = self.backbone_features(batch["image"], batch["valid_hw"])
        with record_function("roi_pool"):
            return feat, self._pool(feat, batch["boxes"], batch["prop_valid"],
                                    batch["objectness"])

    def loss(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
             cur_iter: int = 0, cpgs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One image. batch: image (H, W, 3) BGR raw (padded), valid_hw (2,),
        boxes (P, 4), objectness (P,), prop_valid (P,) bool, gt_classes_oh
        (K,). ``cur_iter`` is the training step (read by CMIL, CSC and
        WSJDS); ``cpgs`` (K, H, W), the CSC and WSJDS heads' maps from
        ``compute_cpgs``. Returns the head's f32 loss terms; dropout draws
        from ``generator``. Profiler ranges: ``backbone``, ``roi_pool`` and
        the head's."""
        feat, pooled = self._pooled(batch)
        if self.head == "CSC":
            return self.roi_heads.losses(pooled, batch["boxes"], batch["prop_valid"],
                                         batch["gt_classes_oh"], cpgs,
                                         cur_iter <= self.csc_max_iter, generator)
        if self.head == "WSJDS":
            return self.roi_heads.losses(pooled, batch["boxes"], batch["prop_valid"],
                                         batch["gt_classes_oh"], cpgs, feat, batch["image"],
                                         cur_iter <= self.csc_max_iter, generator)
        args = (pooled, batch["boxes"], batch["prop_valid"], batch["gt_classes_oh"], generator)
        if self.head == "CMIL":
            return self.roi_heads.losses(*args, cur_iter=cur_iter)
        return self.roi_heads.losses(*args)

    def forward_scores(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Image -> the (P, K) MIL proposal scores of the CSC or WSJDS head,
        in training mode (dropout from ``generator``): the function whose
        gradient with respect to the image gives the CPG maps."""
        if not self.uses_cpgs:
            raise ValueError("forward_scores is the CSC and WSJDS heads'; this model has "
                             f"{self.head}")
        return self.roi_heads.scores(self._pooled(batch)[1], batch["prop_valid"], generator)

    def compute_cpgs(self, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The (K, H, W) CPG maps of the raw (H, W, 3) image, detached: for
        each class present whose image score (from the same forward) is at
        least ``csc_tau``, |d sum_p scores[p, c] / d image| maxed over the
        channels, normalised to a peak of 1; zero for the other classes.
        Dropout draws from ``generator`` as the loss's forward does: a
        caller that wants the loss to see the same masks restores the
        generator's state in between (``Stage1Trainer`` does)."""
        image = batch["image"].detach().float().requires_grad_(True)
        with torch.enable_grad():
            scores = self.forward_scores({**batch, "image": image}, generator)
            return compute_cpg(scores, image, batch["gt_classes_oh"],
                               mil_image_scores(scores.detach()), tau=self.csc_tau)

    def _predict(self, batch: Dict[str, torch.Tensor]):
        feat, pooled = self._pooled(batch)
        with record_function("box_head"):
            scores, boxes = self.roi_heads.predict(pooled, batch["boxes"], batch["prop_valid"])
        return feat, scores, boxes

    def predict_scores(self, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(all_scores (P, K+1) background last, all_boxes (P, K*4) or the
        proposals (P, 4)), without the NMS (nor WSJDS's masks)."""
        return self._predict(batch)[1:]

    def predict(self, batch: Dict[str, torch.Tensor]):
        """Single-image inference, the batch of ``MultiInputRCNN.predict``
        (image, valid_hw, boxes, objectness, prop_valid, image_hw). Returns
        (Detections, all_scores, all_boxes), and for WSJDS also its (K, H, W)
        f32 class masks at the canvas size, as the JAX model does. Profiler
        ranges ``backbone``, ``roi_pool``, ``box_head``, ``nms_topk`` (and
        WSJDS's ``sem_seg``)."""
        feat, scores, pred_boxes = self._predict(batch)
        with record_function("nms_topk"):
            det = fast_rcnn_inference_single(
                pred_boxes, scores, batch["prop_valid"], batch["image_hw"],
                score_thresh=self.score_thresh, nms_thresh=self.nms_thresh,
                topk=self.detections_per_image)
        if self.head == "WSJDS":
            return det, scores, pred_boxes, self.roi_heads.predict_masks(
                feat, tuple(batch["image"].shape[:2]))
        return det, scores, pred_boxes

    @classmethod
    def from_cfg(cls, cfg, device=None, **overrides) -> "GeneralizedRCNNWSL":
        head = HEAD_NAME_MAP.get(cfg.MODEL.ROI_HEADS.NAME, cfg.MODEL.ROI_HEADS.NAME)
        kw = dict(
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            head=head,
            backbone_name=("ws_resnet" if "resnet" in cfg.MODEL.BACKBONE.NAME.lower()
                           else "vgg16"),
            resnet_depth=cfg.MODEL.RESNETS.DEPTH,
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            conv5_dilation=cfg.MODEL.VGG.CONV5_DILATION,
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
            pooler_type=cfg.MODEL.ROI_BOX_HEAD.POOLER_TYPE,
            pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            refine_k=cfg.WSL.REFINE_NUM,
            refine_reg=tuple(cfg.WSL.REFINE_REG),
            mean_loss=cfg.WSL.MEAN_LOSS,
            dan_dims=tuple(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM),
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            size_epoch=cfg.WSL.SIZE_EPOCH,
            max_iter=cfg.SOLVER.MAX_ITER,
            csc_max_iter=cfg.WSL.CSC_MAX_ITER,
            compute_dtype=(torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16"
                           else torch.float32),
        )
        kw.update(overrides)
        return cls(device=device, **kw)


def build_stage1_model(cfg, device=None):
    """The stage-1 model of ``cfg``, as the JAX CLI picks it:
    ``MultiInputRCNN`` for that MODEL.META_ARCHITECTURE, else
    ``GeneralizedRCNNWSL``."""
    cls = (MultiInputRCNN if cfg.MODEL.META_ARCHITECTURE == "MultiInputRCNN"
           else GeneralizedRCNNWSL)
    return cls.from_cfg(cfg, device=device)
