"""Detection post-processing: score filter + per-class NMS + top-k, masked.

Counterpart of ``sos_wsod_tpu/models/postprocess.py`` (reference
``fast_rcnn_inference_single_image``): drop the background column, clip boxes,
filter score > score_thresh per (proposal, class) pair, per-class NMS, keep the
top-k by score. The per-class NMS problems run as one batched (K, P, P)
fixpoint.
"""
from __future__ import annotations

import torch

from ..core.boxes import clip_boxes
from ..core.instances import Detections
from ..ops.nms import nms_mask


def fast_rcnn_inference_single(
    pred_boxes: torch.Tensor,   # (P, K*4) or (P, 4) class-agnostic
    scores: torch.Tensor,       # (P, K+1), background last
    prop_valid: torch.Tensor,   # (P,)
    image_hw: torch.Tensor,     # (2,) (h, w) of the model input image
    *,
    score_thresh: float,
    nms_thresh: float,
    topk: int,
) -> Detections:
    p, k1 = scores.shape
    k = k1 - 1
    finite = torch.isfinite(pred_boxes).all(dim=1) & torch.isfinite(scores).all(dim=1)
    base_valid = prop_valid & finite

    cls_scores = scores[:, :k].float()
    nb = pred_boxes.shape[1] // 4
    hw = image_hw.float()
    boxes = clip_boxes(pred_boxes.reshape(p, nb, 4), hw[0], hw[1])
    if nb == 1:
        boxes = boxes.expand(p, k, 4)

    cand_valid = base_valid[:, None] & (cls_scores > score_thresh)   # (P, K)
    keep = nms_mask(boxes.transpose(0, 1), cls_scores.T, cand_valid.T, nms_thresh).T
    keep = keep & cand_valid

    flat = torch.where(keep, cls_scores, torch.full_like(cls_scores, float("-inf"))).reshape(-1)
    # stable descending sort: ties keep the lower flat index first, as
    # jax.lax.top_k does (torch.topk leaves the tie order unspecified)
    top_vals, top_idx = torch.sort(flat, descending=True, stable=True)
    top_vals, top_idx = top_vals[:topk], top_idx[:topk]
    det_valid = torch.isfinite(top_vals)
    det_cls = top_idx % k
    det_prop = torch.div(top_idx, k, rounding_mode="floor")
    det_boxes = boxes.reshape(p * k, 4)[det_prop * k + det_cls]
    zero = torch.zeros((), dtype=det_boxes.dtype, device=det_boxes.device)
    return Detections(
        boxes=torch.where(det_valid[:, None], det_boxes, zero),
        scores=torch.where(det_valid, top_vals, zero),
        classes=torch.where(det_valid, det_cls, torch.zeros_like(det_cls)),
        valid=det_valid,
    )


def rescale_detections(det: Detections, input_hw: torch.Tensor,
                       output_hw: torch.Tensor) -> Detections:
    """detector_postprocess: rescale boxes from the model-input size to the
    original image size and clip to it."""
    sy = output_hw[0] / input_hw[0]
    sx = output_hw[1] / input_hw[1]
    scale = torch.stack([sx, sy, sx, sy]).to(det.boxes.dtype)
    boxes = clip_boxes(det.boxes * scale[None, :], output_hw[0], output_hw[1])
    return Detections(boxes=boxes, scores=det.scores, classes=det.classes, valid=det.valid)
