"""COCO bbox evaluation in numpy, and the detection-result JSON dump.

Counterpart of ``sos_wsod_tpu/evaluation/coco_eval.py`` (detectron2's
COCOEvaluator over pycocotools' COCOeval, which is not installed): 10 IoU
thresholds .50:.05:.95, 101-point interpolated precision, the area ranges
all/small/medium/large (bounds inclusive), 100 detections an image, greedy
score-ordered matching a (image, class) with crowd ground truth as ignore
regions that take any number of detections (IoU = intersection over the
detection's area). With ``save_detection_result`` it first writes the
detection-result JSON (1-based ``category_id``), the stage-1 -> PGF
hand-off of the COCO runs. No CLI selects it, as in the JAX package.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict, defaultdict
from typing import Dict, Optional

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _intersection(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    return wh[..., 0] * wh[..., 1]


def _area(boxes: np.ndarray) -> np.ndarray:
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def bbox_iou_xyxy(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(D, 4), (G, 4) -> (D, G) IoU, without the +1 pixel of VOC."""
    if dets.size == 0 or gts.size == 0:
        return np.zeros((dets.shape[0], gts.shape[0]))
    inter = _intersection(dets, gts)
    union = _area(dets)[:, None] + _area(gts)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_image(dets, det_scores, gts, gt_areas, area_rng, max_det, gt_crowd=None):
    """Greedy matching of one (image, class). Returns dtm (T, D), the
    matched ground truth's index or -1; dt_ignore (T, D); gt_ignore (G,);
    scores (D,); with D <= ``max_det``, the detections by descending score.
    A ground truth is ignored when crowd or its area is outside
    ``area_rng``; a detection when matched to an ignored one, or unmatched
    with its area outside the range."""
    t = len(IOU_THRS)
    order = np.argsort(-det_scores, kind="mergesort")[:max_det]
    dets = dets[order]
    scores = det_scores[order]
    d, g = dets.shape[0], gts.shape[0]
    if gt_crowd is None:
        gt_crowd = np.zeros(g, bool)
    gt_ig = gt_crowd | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    gind = np.argsort(gt_ig, kind="mergesort")   # ground truth not ignored first
    gts, gt_ig, gt_crowd = gts[gind], gt_ig[gind], gt_crowd[gind]
    ious = bbox_iou_xyxy(dets, gts)
    if gt_crowd.any() and d:
        darea = _area(dets)[:, None]
        iou_crowd = np.where(darea > 0, _intersection(dets, gts) / np.maximum(darea, 1e-12), 0.0)
        ious = np.where(gt_crowd[None, :], iou_crowd, ious)
    dtm = np.zeros((t, d), dtype=np.int64) - 1
    gtm = np.zeros((t, g), dtype=np.int64) - 1
    for ti, thr in enumerate(IOU_THRS):
        for di in range(d):
            iou = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(g):
                if gtm[ti, gi] >= 0 and not gt_crowd[gi]:   # taken, and not a crowd
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[gi]:    # the rest are ignored
                    break
                if ious[di, gi] < iou:
                    continue
                iou = ious[di, gi]
                m = gi
            if m > -1:
                dtm[ti, di] = m
                gtm[ti, m] = di
    det_areas = _area(dets)
    out_of_rng = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
    dt_ig = np.zeros((t, d), dtype=bool)
    for ti in range(t):
        matched = dtm[ti] >= 0
        ig_match = np.zeros(d, bool)
        ig_match[matched] = gt_ig[dtm[ti][matched]]
        dt_ig[ti] = ig_match | (~matched & out_of_rng)
    return dtm, dt_ig, gt_ig, scores


def _accumulate(per_image, num_gt_nonignore):
    """per_image: [(dtm, dt_ig, scores)] of one class -> (precision (T, R),
    recall (T,)), or (None, None) without ground truth."""
    t = len(IOU_THRS)
    if num_gt_nonignore == 0:
        return None, None
    if per_image:
        order = np.argsort(-np.concatenate([s for _, _, s in per_image]), kind="mergesort")
        dtm = np.concatenate([m for m, _, _ in per_image], axis=1)[:, order]
        dt_ig = np.concatenate([i for _, i, _ in per_image], axis=1)[:, order]
    else:
        dtm = np.zeros((t, 0), np.int64)
        dt_ig = np.zeros((t, 0), bool)
    tp_sum = np.cumsum((dtm >= 0) & ~dt_ig, axis=1).astype(np.float64)
    fp_sum = np.cumsum((dtm < 0) & ~dt_ig, axis=1).astype(np.float64)
    precision = np.zeros((t, len(REC_THRS)))
    recall = np.zeros(t)
    for ti in range(t):
        tp, fp = tp_sum[ti], fp_sum[ti]
        rc = tp / num_gt_nonignore
        pr = (tp / np.maximum(tp + fp, np.finfo(np.float64).eps)).tolist()
        recall[ti] = rc[-1] if rc.size else 0.0
        for i in range(len(pr) - 1, 0, -1):   # the non-increasing envelope
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        for ri, pi in enumerate(np.searchsorted(rc, REC_THRS, side="left")):
            if pi < len(pr):
                precision[ti, ri] = pr[pi]
    return precision, recall


class COCOEvaluator:
    """Collects per-image detections; ``evaluate`` returns AP, AP50, AP75,
    APs, APm and APl (percent, NaN where no class has ground truth).

    annotations: {image_id: {"boxes": (N, 4) XYXY, "classes": (N,) 0-based,
    "areas": (N,), "crowd": (N,) bool}}; by default built from the
    catalog's dicts of ``dataset_name``. ``num_classes`` defaults to one
    more than the largest class id of the annotations."""

    def __init__(self, dataset_name: str, annotations: Optional[Dict] = None,
                 num_classes: Optional[int] = None, save_detection_result: bool = False,
                 save_path: str = ""):
        self._dataset_name = dataset_name
        if annotations is None:
            from ..data.catalog import DatasetCatalog

            annotations = {}
            for d in DatasetCatalog.get(dataset_name):
                anns = d.get("annotations", [])
                annotations[d["image_id"]] = {
                    "boxes": np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4),
                    "classes": np.asarray([a["category_id"] for a in anns], np.int64),
                    "areas": np.asarray([a.get("area", (a["bbox"][2] - a["bbox"][0])
                                               * (a["bbox"][3] - a["bbox"][1])) for a in anns],
                                        np.float64),
                    "crowd": np.asarray([bool(a.get("iscrowd", 0)) for a in anns], bool),
                }
        self._annotations = annotations
        if num_classes is None:
            num_classes = 1 + max((int(a["classes"].max()) for a in annotations.values()
                                   if a["classes"].size), default=0)
        self._num_classes = num_classes
        self.save_detection_result = save_detection_result
        self.save_path = save_path
        self.reset()

    def reset(self) -> None:
        self._dets = defaultdict(lambda: defaultdict(list))   # image -> class -> (box, score)

    def process_single(self, image_id, boxes, scores, classes, valid=None) -> None:
        scores = np.asarray(scores, np.float64)
        valid = np.ones(len(scores), bool) if valid is None else np.asarray(valid, bool)
        for box, score, cls, v in zip(np.asarray(boxes, np.float64), scores,
                                      np.asarray(classes, np.int64), valid):
            if v:
                self._dets[image_id][int(cls)].append((box, float(score)))

    def _dump(self) -> None:
        dump = [{"image_id": int(image_id) if str(image_id).isdigit() else image_id,
                 "category_id": cls + 1, "score": round(score, 3),
                 "bbox": [round(float(c), 1) for c in box]}
                for image_id, per_cls in self._dets.items()
                for cls, items in per_cls.items() for box, score in items]
        path = self.save_path.format(self._dataset_name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dump, f)

    def evaluate(self) -> "OrderedDict[str, dict]":
        if self.save_detection_result:
            self._dump()
        stats = {}
        for area_name, rng in AREA_RNG.items():
            precisions = []   # a (T, R) array for each class with ground truth
            for cls in range(self._num_classes):
                per_image, n_gt = [], 0
                for image_id, ann in self._annotations.items():
                    sel = ann["classes"] == cls
                    crowd = ann.get("crowd")
                    items = self._dets.get(image_id, {}).get(cls, [])
                    dets = np.asarray([b for b, _ in items], np.float64).reshape(-1, 4)
                    dscores = np.asarray([s for _, s in items], np.float64)
                    if not sel.any() and dets.size == 0:
                        continue
                    dtm, dt_ig, gt_ig, sc = _evaluate_image(
                        dets, dscores, ann["boxes"][sel], ann["areas"][sel], rng, 100,
                        crowd[sel] if crowd is not None else None)
                    n_gt += int((~gt_ig).sum())
                    per_image.append((dtm, dt_ig, sc))
                p, _ = _accumulate(per_image, n_gt)
                if p is not None:
                    precisions.append(p)
            stats[area_name] = np.stack(precisions) if precisions else None

        def ap(area="all", iou=None):
            p = stats[area]
            if p is None:
                return float("nan")
            if iou is not None:
                ti = int(np.argmin(np.abs(IOU_THRS - iou)))
                p = p[:, ti:ti + 1]
            vals = p[p > -1]
            return float(np.mean(vals) * 100) if vals.size else float("nan")

        ret = OrderedDict()
        ret["bbox"] = {"AP": ap(), "AP50": ap(iou=0.5), "AP75": ap(iou=0.75),
                       "APs": ap("small"), "APm": ap("medium"), "APl": ap("large")}
        return ret
