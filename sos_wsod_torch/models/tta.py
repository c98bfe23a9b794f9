"""Test-time augmentation: the views of an image, and the AVG and UNION
strategies that merge the model's outputs over them.

Counterpart of ``sos_wsod_tpu/models/tta.py`` (the reference's WSL
GeneralizedRCNNWithTTAAVG / ...UNION, and ubteacher's use of detectron2's
GeneralizedRCNNWithTTA for stages 2-3):
  - the views: each of TEST.AUG.MIN_SIZES (ResizeShortestEdge with
    MAX_SIZE), without and with a horizontal flip; the image's proposals go
    through each view's transforms, clipped, padded to ``capacity``;
  - AVG: the per-proposal class scores and the class boxes mapped back to
    the image, averaged over the views in float64 (the caller runs the one
    NMS);
  - UNION: each view's detections mapped back to the image, concatenated,
    one per-class NMS on the host in numpy, the first ``topk`` kept.
The model runs a view at a time through the callables the caller passes
(``tools/train_net_test_tta.py``: on the card); the rest is numpy on the
host, in the JAX package's order and tie rules.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..data import transforms as T
from ..data.mapper_multi import bucket_shape, pad_image


def _view_batches(image: np.ndarray, raw_boxes: np.ndarray, raw_logits: np.ndarray,
                  min_sizes: Sequence[int], max_size: int, flip: bool, capacity: int,
                  size_divisibility: int):
    """Yield (batch, inverse) for each view: the keys of
    ``MultiInputRCNN.predict`` (the first ``capacity`` proposals), and the
    function mapping (N, 4) view boxes back to the image."""
    h, w = image.shape[:2]
    n = min(raw_boxes.shape[0], capacity)
    for ms in min_sizes:
        t = T.resize_shortest_edge(h, w, [ms], max_size)
        ih, iw = t.output_size
        for do_flip in ([False, True] if flip else [False]):
            tfm = T.TransformList([t, T.HFlipTransform(ih, iw)] if do_flip else [t])
            img = tfm.apply_image(image).astype(np.float32)
            bh, bw = bucket_shape(ih, iw, size_divisibility)
            boxes = np.zeros((capacity, 4), np.float32)
            boxes[:n] = T.clip_boxes(tfm.apply_box(raw_boxes[:n]), (ih, iw))
            logits = np.zeros((capacity,), np.float32)
            logits[:n] = raw_logits[:n]
            batch = {
                "image": pad_image(img, bh, bw),
                "valid_hw": np.array([ih, iw], np.int32),
                "boxes": boxes,
                "objectness": logits,
                "prop_valid": np.arange(capacity) < n,
                "image_hw": np.array([ih, iw], np.float32),
            }

            def inverse(view_boxes, tfm=tfm):
                return tfm.inverse_box(np.asarray(view_boxes, np.float64))

            yield batch, inverse


def tta_avg_scores(predict_fn: Callable[[Dict], Tuple[np.ndarray, np.ndarray]],
                   image: np.ndarray, raw_boxes: np.ndarray, raw_logits: np.ndarray, *,
                   min_sizes: Sequence[int], max_size: int = 4000, flip: bool = True,
                   capacity: int = 4096, size_divisibility: int = 64):
    """AVG: ``predict_fn(batch) -> (scores (P, K+1), class boxes (P, 4K))``
    of each view; returns the mean scores, the mean boxes in image
    coordinates (float64) and the proposals' valid flags."""
    sum_scores = sum_boxes = valid = None
    count = 0
    for batch, inverse in _view_batches(image, raw_boxes, raw_logits, min_sizes, max_size, flip,
                                        capacity, size_divisibility):
        scores, boxes = predict_fn(batch)
        scores = np.asarray(scores, np.float64)
        boxes = np.asarray(boxes, np.float64)
        back = inverse(boxes.reshape(-1, 4)).reshape(boxes.shape)
        sum_scores = scores.copy() if sum_scores is None else sum_scores + scores
        sum_boxes = back if sum_boxes is None else sum_boxes + back
        valid = batch["prop_valid"]
        count += 1
    return sum_scores / count, sum_boxes / count, valid


def tta_union_detections(
        infer_fn: Callable[[Dict], Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
        image: np.ndarray, raw_boxes: np.ndarray, raw_logits: np.ndarray, *,
        min_sizes: Sequence[int], max_size: int = 4000, flip: bool = True, capacity: int = 4096,
        size_divisibility: int = 64, nms_thresh: float = 0.5, topk: int = 100):
    """UNION: ``infer_fn(batch) -> (boxes (D, 4), scores, classes, valid)``
    of each view; the valid detections of all views in image coordinates,
    one per-class NMS (``_batched_nms_np``), the first ``topk``. Returns
    (boxes float64, scores float64, classes int64)."""
    all_b: List[np.ndarray] = []
    all_s: List[np.ndarray] = []
    all_c: List[np.ndarray] = []
    for batch, inverse in _view_batches(image, raw_boxes, raw_logits, min_sizes, max_size, flip,
                                        capacity, size_divisibility):
        boxes, scores, classes, valid = infer_fn(batch)
        keep = np.asarray(valid, bool)
        all_b.append(inverse(np.asarray(boxes, np.float64)[keep]))
        all_s.append(np.asarray(scores, np.float64)[keep])
        all_c.append(np.asarray(classes, np.int64)[keep])
    boxes = np.concatenate(all_b) if all_b else np.zeros((0, 4))
    scores = np.concatenate(all_s) if all_s else np.zeros(0)
    classes = np.concatenate(all_c) if all_c else np.zeros(0, np.int64)
    keep = _batched_nms_np(boxes, scores, classes, nms_thresh)[:topk]
    return boxes[keep], scores[keep], classes[keep]


def _batched_nms_np(boxes: np.ndarray, scores: np.ndarray, idxs: np.ndarray,
                    thr: float) -> np.ndarray:
    """Greedy per-class NMS (classes apart by a coordinate offset), in
    float64: the kept indices by descending score, ties in input order; a
    box is suppressed by a kept one with IoU > ``thr``."""
    if boxes.size == 0:
        return np.zeros(0, np.int64)
    offsets = idxs.astype(np.float64) * (boxes.max() + 1)
    b = boxes + offsets[:, None]
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    keep = []
    suppressed = np.zeros(len(scores), bool)
    for i in np.argsort(-scores, kind="mergesort"):
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(b[i, 0], b[:, 0])
        yy1 = np.maximum(b[i, 1], b[:, 1])
        xx2 = np.minimum(b[i, 2], b[:, 2])
        yy2 = np.minimum(b[i, 3], b[:, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        suppressed |= inter / np.maximum(areas[i] + areas - inter, 1e-12) > thr
    return np.asarray(keep, np.int64)
