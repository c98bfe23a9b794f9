"""Pascal VOC AP / CorLoc evaluation and the detection-result JSON (numpy).

Counterpart of ``sos_wsod_tpu/evaluation/voc_eval.py``: the official VOC
devkit's AP (+1 pixel IoU, difficult objects neither hit nor miss, the 2007
11-point metric), CorLoc, AP over IoU .50:.95, and the COCO-style JSON dump
(1-based ``category_id``) that stage 2 reads its pseudo-boxes from.
Detections stay in memory, rounded as the devkit's text files round them
(score to 3 decimals, coordinates to 1). ``annotations_from_dataset_dicts``
builds the evaluator's ground truth from a dataset's XML files.
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.voc import CLASS_NAMES


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0   # a plain running sum: sum() of floats compensates since 3.12
        for t in np.arange(0.0, 1.1, 0.1):
            ap += (float(prec[rec >= t].max()) if (rec >= t).any() else 0.0) / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.maximum.accumulate(np.concatenate(([0.0], prec, [0.0]))[::-1])[::-1]
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _class_gt(annotations: Dict[str, dict], cls: int):
    """Per-image ground truth of class ``cls``: {image_id: {bbox, difficult,
    det}}, the number of non-difficult objects, and the number of images with
    at least one."""
    recs, npos, npos_im = {}, 0, 0
    for image_id, ann in annotations.items():
        sel = np.asarray(ann["classes"]) == cls
        difficult = np.asarray(ann["difficult"], bool)[sel]
        npos += int((~difficult).sum())
        npos_im += int((~difficult).any())
        recs[str(image_id)] = {"bbox": np.asarray(ann["boxes"], np.float64).reshape(-1, 4)[sel],
                               "difficult": difficult, "det": np.zeros(int(sel.sum()), bool)}
    return recs, npos, npos_im


def _overlaps_voc(bbgt: np.ndarray, bb: np.ndarray) -> np.ndarray:
    """IoU of one box against (N, 4) boxes, +1 pixel convention."""
    iw = np.maximum(np.minimum(bbgt[:, 2], bb[2]) - np.maximum(bbgt[:, 0], bb[0]) + 1.0, 0.0)
    ih = np.maximum(np.minimum(bbgt[:, 3], bb[3]) - np.maximum(bbgt[:, 1], bb[1]) + 1.0, 0.0)
    inters = iw * ih
    union = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
             + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0) - inters)
    return inters / union


def voc_eval(detections: List[tuple], annotations: Dict[str, dict], cls: int,
             ovthresh: float = 0.5, use_07_metric: bool = False):
    """detections: (image_id, score, x1, y1, x2, y2) of one class, in the
    devkit's 1-based coordinates. Returns (recall, precision, AP)."""
    recs, npos, _ = _class_gt(annotations, cls)
    if not detections:
        return np.zeros(0), np.zeros(0), 0.0
    order = np.argsort(-np.array([d[1] for d in detections], np.float64))
    tp = np.zeros(len(order))
    fp = np.zeros(len(order))
    for n, i in enumerate(order):
        r = recs[str(detections[i][0])]
        if not r["bbox"].size:
            fp[n] = 1.0
            continue
        overlaps = _overlaps_voc(r["bbox"], np.asarray(detections[i][2:6], np.float64))
        j = int(np.argmax(overlaps))
        if not overlaps[j] > ovthresh:
            fp[n] = 1.0
        elif not r["difficult"][j]:
            if r["det"][j]:
                fp[n] = 1.0
            else:
                tp[n] = 1.0
                r["det"][j] = True
    tp, fp = np.cumsum(tp), np.cumsum(fp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_eval_corloc(detections: List[tuple], annotations: Dict[str, dict], cls: int,
                    ovthresh: float = 0.5) -> float:
    """Share of the images holding a non-difficult object of ``cls`` whose
    most confident detection of ``cls`` hits a ground-truth box."""
    recs, _, npos_im = _class_gt(annotations, cls)
    if not detections or npos_im == 0:
        return 0.0
    order = np.argsort(-np.array([d[1] for d in detections], np.float64))
    seen, hits = set(), 0
    for i in order:
        image_id = str(detections[i][0])
        r = recs[image_id]
        if image_id in seen or not len(r["difficult"]) or r["difficult"].all():
            continue
        seen.add(image_id)
        ovmax = _overlaps_voc(r["bbox"], np.asarray(detections[i][2:6], np.float64)).max()
        hits += bool(ovmax > ovthresh)
    return hits / npos_im


class PascalVOCDetectionEvaluator:
    """Collects per-image detections; ``evaluate`` returns AP and CorLoc over
    IoU .50:.95 and, with ``save_detection_result``, first writes the
    detection-result JSON to ``save_path.format(dataset_name)``.

    annotations: {image_id: {"boxes": (N, 4) devkit 1-based XYXY,
    "classes": (N,) 0-based ids, "difficult": (N,) bool}}."""

    def __init__(self, dataset_name: str, annotations: Dict[str, dict],
                 class_names: Sequence[str], year: int = 2007,
                 save_detection_result: bool = False, save_path: str = ""):
        self._dataset_name = dataset_name
        self._annotations = annotations
        self._class_names = list(class_names)
        self._is_2007 = int(year) == 2007
        self.save_detection_result = save_detection_result
        self.save_path = save_path
        self.reset()

    def reset(self) -> None:
        self._predictions = defaultdict(list)   # class id -> detection tuples

    def process_single(self, image_id, boxes, scores, classes, valid=None) -> None:
        """boxes: (N, 4) 0-based XYXY in the original image size."""
        scores = np.asarray(scores, np.float64)
        valid = np.ones(len(scores), bool) if valid is None else np.asarray(valid, bool)
        for (x1, y1, x2, y2), score, cls in zip(np.asarray(boxes, np.float64)[valid],
                                                scores[valid],
                                                np.asarray(classes, np.int64)[valid]):
            self._predictions[int(cls)].append((
                str(image_id), float(f"{score:.3f}"), float(f"{x1 + 1:.1f}"),
                float(f"{y1 + 1:.1f}"), float(f"{x2:.1f}"), float(f"{y2:.1f}")))

    def evaluate(self) -> "OrderedDict[str, dict]":
        if self.save_detection_result:
            result = [{"image_id": int(image_id), "category_id": cls + 1, "score": score,
                       "bbox": [x1, y1, x2, y2]}
                      for cls in range(len(self._class_names))
                      for image_id, score, x1, y1, x2, y2 in self._predictions.get(cls, [])]
            path = self.save_path.format(self._dataset_name)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(result, f)

        thresholds = range(50, 100, 5)
        aps = defaultdict(list)
        corlocs = defaultdict(list)
        for cls in range(len(self._class_names)):
            dets = self._predictions.get(cls, [])
            for t in thresholds:
                aps[t].append(100 * voc_eval(dets, self._annotations, cls, t / 100.0,
                                             self._is_2007)[2])
                corlocs[t].append(100 * voc_eval_corloc(dets, self._annotations, cls,
                                                        t / 100.0))
        ret = OrderedDict()
        m_ap = {t: np.mean(aps[t]) for t in thresholds}
        ret["bbox"] = {"AP": float(np.mean(list(m_ap.values()))), "AP50": float(m_ap[50]),
                       "AP75": float(m_ap[75])}
        m_cl = {t: np.mean(corlocs[t]) for t in thresholds}
        ret["corloc"] = {"CorLoc": float(np.mean(list(m_cl.values()))),
                         "CorLoc50": float(m_cl[50]), "CorLoc75": float(m_cl[75])}
        return ret


def annotations_from_dataset_dicts(dataset_dicts: List[dict],
                                   dirname: Optional[str] = None) -> Dict[str, dict]:
    """The evaluator's ground truth, {image_id: {boxes, classes, difficult}},
    from ``dirname``/Annotations/<image_id>.xml where that file exists (the
    XML keeps the difficult objects the loader drops), else from the dict's
    0-based annotations, shifted back to the devkit's 1-based x1, y1."""
    out = {}
    for d in dataset_dicts:
        image_id = str(d["image_id"])
        xml_path = os.path.join(dirname, "Annotations", image_id + ".xml") if dirname else None
        if xml_path and os.path.isfile(xml_path):
            objs = ET.parse(xml_path).findall("object")
            boxes = [[int(o.find("bndbox").find(x).text) for x in ("xmin", "ymin", "xmax", "ymax")]
                     for o in objs]
            classes = [CLASS_NAMES.index(o.find("name").text) for o in objs]
            difficult = [int(o.find("difficult").text) for o in objs]
        else:
            ann = d.get("annotations", [])
            boxes = [[a["bbox"][0] + 1, a["bbox"][1] + 1, a["bbox"][2], a["bbox"][3]] for a in ann]
            classes = [a["category_id"] for a in ann]
            difficult = [a.get("difficult", False) for a in ann]
        out[image_id] = {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
                         "classes": np.asarray(classes, np.int64),
                         "difficult": np.asarray(difficult, bool)}
    return out
