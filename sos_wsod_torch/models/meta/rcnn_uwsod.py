"""UWSOD meta-architectures: a weakly-supervised RPN + the UWSOD ROI head.

Counterpart of ``sos_wsod_tpu/models/meta/rcnn_uwsod.py`` (the reference's
GeneralizedRCNNWSL with PROPOSAL_GENERATOR "RPNWSL"):
  - ``UWSODRCNN``: VGG16 with dilated conv5 (stride 8) and the padding
    beyond the valid extent masked, the RPN on plain5 (5 sizes x 3 ratios,
    train and test top-k ``pre_nms_topk`` / ``post_nms_topk``), ROIPool
    (kernel A) into 7x7 with the objectness weight fused as its row scale,
    the UWSOD head, and the RPN's loss against the pseudo-GT that the head
    mined in the same step (the reference stashes the RPN's outputs and
    takes the loss later; here ``RPN.proposals`` returns the head outputs and
    ``RPN.losses`` takes them with the pseudo-GT);
  - ``MRRPUWSODRCNN``: the MRRP VGG16, whose B branches enter the RPN as B
    same-stride levels (per-branch anchors, one NMS over all, kernel C);
    each proposal pools from the branch that proposed it: one pool a branch
    over the rows ``valid & (level == b)`` (the others give exactly 0 and no
    gradient), summed.
Neither has a config route or a CLI, as in the JAX package: callers drive
``loss`` and ``predict`` (chip_smoke.py phase 18, the tests). A batch is one
image as the JAX package's: image (H, W, 3) BGR raw, valid_hw (2,) (read by
``UWSODRCNN`` only), image_hw (2,), gt_classes_oh (K,).

The JAX models flatten the pooled ROIs for DAN fc1 in different orders:
``UWSODRCNN`` pools NCHW, (c, h, w); ``MRRPUWSODRCNN`` pools channels-last,
(h, w, c). The port pools channels-last for both, so a JAX tree converts
with ``state_dict_from_flax(params, dan_channels_last=cls.flax_dan_channels_last)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from ...ops.roi_pool import roi_pool
from ..backbones.mrrp import MRRPVGG16
from ..backbones.vgg import VGG16
from ..heads.uwsod import UWSODROIHead, objectness_weight
from ..postprocess import fast_rcnn_inference_single
from ..proposal_generator.rpn import RPN
from .rcnn_wsl import normalize_images


def _hwc(level: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> a contiguous (H, W, C), a view when the map is
    channels_last."""
    return level.permute(0, 2, 3, 1)[0].contiguous()


class _UWSODBase(nn.Module):
    """What the two models share: the RPN over the backbone's levels, the
    UWSOD head, ``loss`` and ``predict``; a model gives ``features`` and
    ``_pool``."""

    def _build(self, backbone: nn.Module, stride: int, levels: Sequence[str], device, *,
               head: dict, rpn: dict, anchor_sizes, aspect_ratios, pre_nms_topk: int,
               post_nms_topk: int, pooler_resolution: int, pixel_mean, pixel_std,
               score_thresh: float, nms_thresh: float, detections_per_image: int) -> None:
        """The modules around ``backbone``: the RPN over its ``levels`` (one
        stride, the same anchors on each; the train top-k at test time too,
        as in the JAX package) and the UWSOD head (``rpn_on``)."""
        n = len(levels)
        self.backbone = backbone
        self.stride = stride
        self.levels = tuple(levels)
        self.proposal_generator = RPN(
            in_features=self.levels, strides=(stride,) * n,
            anchor_sizes=(tuple(anchor_sizes),) * n, aspect_ratios=(tuple(aspect_ratios),) * n,
            in_channels=backbone.out_channels, pre_nms_topk_train=pre_nms_topk,
            post_nms_topk_train=post_nms_topk, pre_nms_topk_test=pre_nms_topk,
            post_nms_topk_test=post_nms_topk, device=device, **rpn)
        self.roi_heads = UWSODROIHead(backbone.out_channels * pooler_resolution ** 2,
                                      rpn_on=True, device=device, **head)
        self.pooler_resolution = pooler_resolution
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_image = detections_per_image

    def _proposals(self, batch, train: bool):
        """(boxes (P, 4), valid (P,), the RPN head's outputs, the pooled
        ROIs); profiler ranges ``backbone``, ``rpn``, ``roi_pool``."""
        with record_function("backbone"):
            fdict = self.features(batch)
        with record_function("rpn"):
            props, head_out = self.proposal_generator.proposals(
                fdict, batch["image_hw"], train=train, return_levels=len(self.levels) > 1)
        boxes, logits, valid = props[:3]
        with record_function("roi_pool"):
            pooled = self._pool(fdict, boxes, valid, logits, *props[3:])
        return boxes, valid, head_out, pooled

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One image -> the head's f32 loss terms and the RPN's (loss_rpn_cls,
        loss_rpn_loc) against the head's pseudo-GT. Dropout, the head's
        subsampling and then the RPN's draw from ``generator``. Profiler
        ranges ``backbone``, ``rpn``, ``roi_pool``, ``box_head``, ``mining``,
        ``losses``."""
        boxes, valid, head_out, pooled = self._proposals(batch, train=True)
        losses, rpn_gt = self.roi_heads.losses(pooled, boxes, valid, batch["gt_classes_oh"],
                                               generator)
        with record_function("losses"):
            losses.update(self.proposal_generator.losses(head_out, rpn_gt.boxes, rpn_gt.valid,
                                                         generator))
        return losses

    def predict(self, batch: Dict[str, torch.Tensor]):
        """One image -> (Detections, scores (P, K+1) with the background
        last, boxes (P, K*4)); the test top-k. Profiler ranges ``backbone``,
        ``rpn``, ``roi_pool``, ``box_head``, ``nms_topk``."""
        boxes, valid, _, pooled = self._proposals(batch, train=False)
        with record_function("box_head"):
            scores, pred_boxes = self.roi_heads.predict(pooled, boxes, valid)
        with record_function("nms_topk"):
            det = fast_rcnn_inference_single(
                pred_boxes, scores, valid, batch["image_hw"], score_thresh=self.score_thresh,
                nms_thresh=self.nms_thresh, topk=self.detections_per_image)
        return det, scores, pred_boxes


class UWSODRCNN(_UWSODBase):
    flax_dan_channels_last = False   # the JAX model pools NCHW: fc1 rows in (c, h, w)

    def __init__(self, num_classes: int = 20,
                 pixel_mean: Sequence[float] = (103.939, 116.779, 123.68),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0), conv5_dilation: int = 2,
                 freeze_at: int = 2, pooler_resolution: int = 7, refine_k: int = 4,
                 refine_reg: Sequence[bool] = (True, True, True, True),
                 refine_mist: bool = False, sampling_on: bool = False,
                 batch_sizes: Sequence[int] = (4096, 4096, 4096, 4096),
                 positive_fractions: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 mean_loss: bool = True, dan_dims: Sequence[int] = (4096, 4096),
                 dan_dropout: float = 0.5,
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0), rpn_batch_size: int = 256,
                 rpn_positive_fraction: float = 0.5, pre_nms_topk: int = 2000,
                 post_nms_topk: int = 1000, score_thresh: float = 1e-6,
                 nms_thresh: float = 0.3, detections_per_image: int = 100, device=None):
        super().__init__()
        self._build(
            VGG16(conv5_dilation=conv5_dilation, freeze_at=freeze_at, device=device),
            8 if conv5_dilation == 2 else 16, ("plain5",), device,
            head=dict(num_classes=num_classes, refine_k=refine_k, refine_reg=tuple(refine_reg),
                      refine_mist=refine_mist, sampling_on=sampling_on,
                      batch_sizes=tuple(batch_sizes),
                      positive_fractions=tuple(positive_fractions), mean_loss=mean_loss,
                      dan_dims=tuple(dan_dims), dan_dropout=dan_dropout),
            rpn=dict(batch_size_per_image=rpn_batch_size,
                     positive_fraction=rpn_positive_fraction),
            anchor_sizes=anchor_sizes, aspect_ratios=aspect_ratios, pre_nms_topk=pre_nms_topk,
            post_nms_topk=post_nms_topk, pooler_resolution=pooler_resolution,
            pixel_mean=pixel_mean, pixel_std=pixel_std, score_thresh=score_thresh,
            nms_thresh=nms_thresh, detections_per_image=detections_per_image)

    def features(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The RPN's levels, each NCHW (1, C, H/s, W/s) in channels_last memory."""
        x = normalize_images(batch["image"][None], self.pixel_mean, self.pixel_std)
        return {"plain5": self.backbone(x, batch["valid_hw"][None])}

    def _pool(self, fdict, boxes, valid, objectness) -> torch.Tensor:
        res = (self.pooler_resolution, self.pooler_resolution)
        scale = objectness_weight(objectness, self.roi_heads.rpn_on)
        return roi_pool(_hwc(fdict["plain5"]), boxes, valid, scale,
                        spatial_scale=1.0 / self.stride, output_size=res)


class MRRPUWSODRCNN(_UWSODBase):
    flax_dan_channels_last = True   # the JAX model pools channels-last: (h, w, c)

    def __init__(self, num_classes: int = 20,
                 pixel_mean: Sequence[float] = (103.939, 116.779, 123.68),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0), freeze_at: int = 2,
                 branch_dilations: Sequence[int] = (1, 2, 3), pooler_resolution: int = 7,
                 refine_k: int = 4, refine_reg: Sequence[bool] = (True, True, True, True),
                 mean_loss: bool = True, dan_dims: Sequence[int] = (4096, 4096),
                 dan_dropout: float = 0.5,
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0), pre_nms_topk: int = 2000,
                 post_nms_topk: int = 1000, score_thresh: float = 1e-6,
                 nms_thresh: float = 0.3, detections_per_image: int = 100, device=None):
        super().__init__()
        nb = len(tuple(branch_dilations))
        self._build(
            MRRPVGG16(freeze_at=freeze_at, branch_dilations=branch_dilations, device=device), 8,
            tuple(f"b{i}" for i in range(nb)), device,
            head=dict(num_classes=num_classes, refine_k=refine_k, refine_reg=tuple(refine_reg),
                      mean_loss=mean_loss, dan_dims=tuple(dan_dims), dan_dropout=dan_dropout),
            rpn={}, anchor_sizes=anchor_sizes, aspect_ratios=aspect_ratios,
            pre_nms_topk=pre_nms_topk, post_nms_topk=post_nms_topk,
            pooler_resolution=pooler_resolution, pixel_mean=pixel_mean, pixel_std=pixel_std,
            score_thresh=score_thresh, nms_thresh=nms_thresh,
            detections_per_image=detections_per_image)

    def features(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Branch b as level ``b{b}``, NCHW (1, C, H/8, W/8)."""
        x = normalize_images(batch["image"][None], self.pixel_mean, self.pixel_std)
        branches = self.backbone(x)
        return {name: branches[i:i + 1] for i, name in enumerate(self.levels)}

    def _pool(self, fdict, boxes, valid, objectness, levels) -> torch.Tensor:
        """Each proposal from its own branch: one pool a branch over the rows
        ``valid & (levels == b)``, summed."""
        res = (self.pooler_resolution, self.pooler_resolution)
        scale = objectness_weight(objectness, self.roi_heads.rpn_on)
        pooled = None
        for b, name in enumerate(self.levels):
            p = roi_pool(_hwc(fdict[name]), boxes, valid & (levels == b), scale,
                         spatial_scale=1.0 / self.stride, output_size=res)
            pooled = p if pooled is None else pooled + p
        return pooled
