"""Region Proposal Network (FPN multi-level).

Counterpart of ``sos_wsod_tpu/models/proposal_generator/rpn.py`` (detectron2
RPN + StandardRPNHead, find_top_rpn_proposals, and ubteacher's PseudoLabRPN
loss gating): the shared 3x3 conv head, per-level objectness and deltas in
(H, W, A) order, decoding against the anchors, the pre-NMS top-k per level,
clipping, one NMS over all levels by the coordinate-offset trick
(``batched_nms_mask``, kernel C on the card) and the post-NMS top-k, all at
fixed shapes with a validity mask. A top-k is a stable descending sort
sliced, so ties keep the lower index first, as ``jax.lax.top_k`` does.

``proposals`` takes the train top-k with ``train=True``; ``losses`` (JAX's
``compute_loss`` branch) are computed from ``proposals``' head outputs:
anchors matched to the ground truth at [0.3, 0.7] with
low-quality matches, ``batch_size_per_image`` anchors sampled at
``positive_fraction`` (``core/sampling.py``), the objectness BCE over the
sampled anchors and the L1 (smooth L1 for beta > 0) of the positives'
deltas, both over ``batch_size_per_image``, times ``loss_weight``. The
proposals carry no gradient, as the JAX package stops it.

Several levels may share a stride and anchors (the MRRP backbone's branches
``b0..b2``): each is its own NMS group, and ``return_levels`` also gives
each kept proposal's level, so that the caller pools it from its own map.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ...core.boxes import apply_deltas, get_deltas, pairwise_iou
from ...core.matcher import Matcher
from ...core.sampling import subsample_masks
from ...ops.nms import batched_nms_mask
from ..anchors import AnchorGenerator


class RPNHead(nn.Module):
    """3x3 conv + 1x1 objectness and delta heads, shared across levels."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1, device=device)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1, device=device)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1, device=device)

    def forward(self, features: Sequence[torch.Tensor]):
        """Per level NCHW (1, C, H, W) -> logits (1, A, H, W), deltas (1, 4A, H, W)."""
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


def _flatten_level(logits: torch.Tensor, deltas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1, A, H, W) -> (H*W*A,); (1, 4A, H, W) -> (H*W*A, 4), in the
    (H, W, A) order of the anchors."""
    lg = logits[0].permute(1, 2, 0)
    dl = deltas[0].permute(1, 2, 0)
    return lg.reshape(-1), dl.reshape(-1, 4)


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def find_top_rpn_proposals(level_logits: List[torch.Tensor], level_boxes: List[torch.Tensor],
                           image_hw: torch.Tensor, *, pre_nms_topk: int, post_nms_topk: int,
                           nms_thresh: float = 0.7, min_size: float = 0.0,
                           return_levels: bool = False):
    """Per level (HWA,) logits and (HWA, 4) decoded boxes, image_hw (2,) ->
    (boxes (post, 4), logits (post,), valid (post,)), and with
    ``return_levels`` each slot's int32 level too (an invalid slot's is the
    level of the candidate the top-k put there, as in the JAX package)."""
    cand_scores, cand_boxes, cand_lvl = [], [], []
    h = image_hw[0].float()
    w = image_hw[1].float()
    lim = torch.stack([w, h, w, h])
    for lvl, (logits, boxes) in enumerate(zip(level_logits, level_boxes)):
        k = min(pre_nms_topk, logits.shape[0])
        scores, idx = _top_k(logits.float(), k)
        b = torch.minimum(boxes[idx].clamp(min=0.0), lim)
        keep = ((b[:, 2] - b[:, 0]) > min_size) & ((b[:, 3] - b[:, 1]) > min_size)
        keep &= torch.isfinite(scores)
        cand_scores.append(torch.where(keep, scores, torch.full_like(scores, float("-inf"))))
        cand_boxes.append(b)
        cand_lvl.append(torch.full((k,), lvl, dtype=torch.int32, device=b.device))
    scores = torch.cat(cand_scores)
    boxes = torch.cat(cand_boxes)
    lvls = torch.cat(cand_lvl)
    valid = torch.isfinite(scores)

    keep = batched_nms_mask(boxes, scores, lvls, valid, nms_thresh) & valid
    sel = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = _top_k(sel, post_nms_topk)
    out_valid = torch.isfinite(top_scores)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out = (torch.where(out_valid[:, None], boxes[top_idx], zero),
           torch.where(out_valid, top_scores, zero), out_valid)
    return out + (lvls[top_idx],) if return_levels else out


def label_and_sample_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                             gt_valid: torch.Tensor, matcher: Matcher,
                             batch_size_per_image: int, positive_fraction: float,
                             generator: torch.Generator):
    """anchors (N, 4) of all levels, gt (G, 4) with gt_valid (G,) ->
    (pos_keep (N,), neg_keep (N,), matched gt row (N,)); every anchor is
    negative when no gt is valid."""
    matched, labels = matcher(pairwise_iou(gt_boxes, anchors), gt_valid)
    labels = torch.where(gt_valid.any(), labels, torch.zeros_like(labels))
    pos_keep, neg_keep = subsample_masks(labels == 1, labels == 0, batch_size_per_image,
                                         positive_fraction, generator)
    return pos_keep, neg_keep, matched


def rpn_losses(pred_logits: torch.Tensor, pred_deltas: torch.Tensor, anchors: torch.Tensor,
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor, matcher: Matcher,
               generator: torch.Generator, *, batch_size_per_image: int = 256,
               positive_fraction: float = 0.5, smooth_l1_beta: float = 0.0,
               bbox_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
               ) -> Dict[str, torch.Tensor]:
    """pred_logits (N,), pred_deltas (N, 4), anchors (N, 4) -> loss_rpn_cls
    (BCE over the sampled anchors) and loss_rpn_loc (L1, or smooth L1 for
    beta > 0, of the positives' deltas), both over batch_size_per_image."""
    pos, neg, matched = label_and_sample_anchors(anchors, gt_boxes, gt_valid, matcher,
                                                 batch_size_per_image, positive_fraction,
                                                 generator)
    # a per-image constant (detectron2 divides by batch_size_per_image x
    # images, the JAX package per image before its mean over the batch), so
    # DDP's mean over ranks of equal local batches is the global mean
    normalizer = float(batch_size_per_image)
    tgt = get_deltas(anchors, gt_boxes[matched], bbox_reg_weights)
    diff = (pred_deltas.float() - tgt).abs()
    if smooth_l1_beta > 0:
        l1 = torch.where(diff < smooth_l1_beta, 0.5 * diff * diff / smooth_l1_beta,
                         diff - 0.5 * smooth_l1_beta)
    else:
        l1 = diff
    zero = torch.zeros((), dtype=torch.float32, device=anchors.device)
    loss_loc = torch.where(pos[:, None], l1, zero).sum() / normalizer
    logits = pred_logits.float()
    bce = logits.clamp(min=0) - logits * pos.float() + torch.log1p(torch.exp(-logits.abs()))
    loss_cls = torch.where(pos | neg, bce, zero).sum() / normalizer
    return {"loss_rpn_cls": loss_cls, "loss_rpn_loc": loss_loc}


class RPN(nn.Module):
    """Multi-level RPN, one image at a time (MODEL.RPN.*)."""

    def __init__(self, in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6"),
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes: Sequence[Sequence[float]] = ((32,), (64,), (128,), (256,), (512,)),
                 aspect_ratios: Sequence[Sequence[float]] = ((0.5, 1.0, 2.0),),
                 anchor_offset: float = 0.0, in_channels: int = 256,
                 iou_thresholds: Sequence[float] = (0.3, 0.7),
                 iou_labels: Sequence[int] = (0, -1, 1), batch_size_per_image: int = 256,
                 positive_fraction: float = 0.5, smooth_l1_beta: float = 0.0,
                 nms_thresh: float = 0.7, min_size: float = 0.0, pre_nms_topk_train: int = 2000,
                 post_nms_topk_train: int = 1000, pre_nms_topk_test: int = 1000,
                 post_nms_topk_test: int = 1000, loss_weight: float = 1.0, device=None):
        super().__init__()
        self.in_features = tuple(in_features)
        self.head = RPNHead(in_channels, len(anchor_sizes[0]) * len(aspect_ratios[0]),
                            device=device)
        self.anchor_gen = AnchorGenerator(sizes=anchor_sizes, aspect_ratios=aspect_ratios,
                                          strides=list(strides), offset=anchor_offset)
        self.matcher = Matcher(list(iou_thresholds), list(iou_labels),
                               allow_low_quality_matches=True)
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.smooth_l1_beta = smooth_l1_beta
        self.nms_thresh = nms_thresh
        self.min_size = min_size
        self.pre_nms_topk_train = pre_nms_topk_train
        self.post_nms_topk_train = post_nms_topk_train
        self.pre_nms_topk_test = pre_nms_topk_test
        self.post_nms_topk_test = post_nms_topk_test
        self.loss_weight = loss_weight
        self._anchors = {}   # (feature shapes, device) -> per-level anchors on the device

    def anchors(self, shapes, device) -> List[torch.Tensor]:
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = [torch.from_numpy(a).to(device) for a in self.anchor_gen(shapes)]
        return self._anchors[key]

    def proposals(self, features: Dict[str, torch.Tensor], image_hw: torch.Tensor, *,
                  train: bool = False, return_levels: bool = False):
        """Per level NCHW (1, C, H, W) features of one image, image_hw (2,)
        -> ((boxes (post, 4), logits (post,), valid (post,)[, levels
        (post,)]), (objectness logits (N,), deltas (N, 4), anchors (N, 4))
        of all levels), with the train or the test top-k. The proposals are
        detached."""
        feats = [features[f] for f in self.in_features]
        logits_l, deltas_l = self.head(feats)
        flat = [_flatten_level(lg, dl) for lg, dl in zip(logits_l, deltas_l)]
        anchors_l = self.anchors([tuple(f.shape[-2:]) for f in feats], feats[0].device)
        boxes_l = [apply_deltas(d.detach().float(), a, (1.0, 1.0, 1.0, 1.0))
                   for (_, d), a in zip(flat, anchors_l)]
        props = find_top_rpn_proposals(
            [lg.detach() for lg, _ in flat], boxes_l, image_hw,
            pre_nms_topk=self.pre_nms_topk_train if train else self.pre_nms_topk_test,
            post_nms_topk=self.post_nms_topk_train if train else self.post_nms_topk_test,
            nms_thresh=self.nms_thresh, min_size=self.min_size, return_levels=return_levels)
        return props, (torch.cat([lg for lg, _ in flat]), torch.cat([d for _, d in flat]),
                       torch.cat(anchors_l))

    def losses(self, head_outputs, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """``rpn_losses`` of ``proposals``' head outputs against the gt, times
        ``loss_weight``."""
        logits, deltas, anchors = head_outputs
        losses = rpn_losses(logits, deltas, anchors, gt_boxes, gt_valid, self.matcher,
                            generator, batch_size_per_image=self.batch_size_per_image,
                            positive_fraction=self.positive_fraction,
                            smooth_l1_beta=self.smooth_l1_beta)
        return {k: v * self.loss_weight for k, v in losses.items()}

    @classmethod
    def from_cfg(cls, cfg, strides=None, device=None) -> "RPN":
        return cls(in_features=tuple(cfg.MODEL.RPN.IN_FEATURES),
                   strides=tuple(strides or (4, 8, 16, 32, 64)),
                   anchor_sizes=tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES),
                   aspect_ratios=tuple(tuple(a) for a in cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS),
                   anchor_offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
                   in_channels=cfg.MODEL.FPN.OUT_CHANNELS,
                   iou_thresholds=tuple(cfg.MODEL.RPN.IOU_THRESHOLDS),
                   iou_labels=tuple(cfg.MODEL.RPN.IOU_LABELS),
                   batch_size_per_image=cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE,
                   positive_fraction=cfg.MODEL.RPN.POSITIVE_FRACTION,
                   smooth_l1_beta=cfg.MODEL.RPN.SMOOTH_L1_BETA,
                   nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
                   min_size=cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
                   pre_nms_topk_train=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
                   post_nms_topk_train=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
                   pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
                   post_nms_topk_test=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
                   loss_weight=cfg.MODEL.RPN.LOSS_WEIGHT, device=device)
