"""Proposal-file conversion and proposal recall (host tools).

Counterpart of ``sos_wsod_tpu/tools/proposals_convert.py`` (the reference's
WSL proposal_convert.py and proposal_recall.py):
  - ``convert_ss_box`` / ``convert_mcg_box``: MATLAB selective-search and
    MCG outputs (boxes 1-based (y1, x1, y2, x2)) -> the detectron2-WSL
    proposal pickle {boxes: [int16 (N, 4) 0-based XYXY], scores: [f32
    (N,)], indexes: [image_id]}; selective search scores are all ones, MCG
    keeps its own;
  - ``proposal_recall``: the share of ground-truth boxes that a top-k
    proposal covers at each IoU threshold (VOC's +1 pixel IoU).
``main`` registers the VOC, COCO and extra WSL sets under ./datasets first.

    python -m sos_wsod_torch.tools.proposals_convert ss  <dataset> <file.mat> <out.pkl>
    python -m sos_wsod_torch.tools.proposals_convert mcg <dataset> <mat_dir>  <out.pkl>
"""
from __future__ import annotations

import os
import pickle
import sys
from typing import Dict, List, Sequence

import numpy as np


def _image_index(dataset_name: str, record: dict):
    if "flickr" in dataset_name or "coco" in dataset_name:
        return os.path.basename(record["file_name"])[:-4]
    return record["image_id"]


def _reorder(mat_boxes: np.ndarray) -> np.ndarray:
    """1-based (y1, x1, y2, x2) -> 0-based XYXY int16."""
    return (mat_boxes[:, (1, 0, 3, 2)] - 1).astype(np.int16)


def convert_ss_box(dataset_name: str, dataset_dicts: List[dict],
                   file_in: str) -> Dict[str, list]:
    import scipy.io as sio

    raw = sio.loadmat(file_in)["boxes"].ravel()
    assert raw.shape[0] == len(dataset_dicts), (raw.shape, len(dataset_dicts))
    return dict(boxes=[_reorder(raw[i]) for i in range(len(dataset_dicts))],
                scores=[np.ones(raw[i].shape[0], np.float32) for i in range(len(dataset_dicts))],
                indexes=[record["image_id"] for record in dataset_dicts])


def convert_mcg_box(dataset_name: str, dataset_dicts: List[dict],
                    dir_in: str) -> Dict[str, list]:
    import scipy.io as sio

    boxes, scores, ids = [], [], []
    for record in dataset_dicts:
        mat = sio.loadmat(os.path.join(dir_in, f"{_image_index(dataset_name, record)}.mat"))
        b, s = ((mat["bboxes"], mat["bboxes_scores"]) if "flickr" in dataset_name
                else (mat["boxes"], mat["scores"]))
        boxes.append(_reorder(b))
        scores.append(np.squeeze(s.astype(np.float32)))
        ids.append(record["image_id"])
    return dict(boxes=boxes, scores=scores, indexes=ids)


def proposal_recall(dataset_dicts: List[dict], proposals: Dict[str, list],
                    iou_thresholds: Sequence[float] = (0.5, 0.7, 0.9),
                    max_num_box: int = 4000) -> List[float]:
    """The share of ground-truth boxes whose best IoU with the top
    ``max_num_box`` proposals by score reaches each threshold."""
    by_id = {i: k for k, i in enumerate(proposals["indexes"])}
    cnt_yes = np.zeros(len(iou_thresholds), np.int64)
    cnt_gt = 0
    for record in dataset_dicts:
        k = by_id[record["image_id"]]
        b = np.asarray(proposals["boxes"][k], np.float64)
        s = np.asarray(proposals["scores"][k], np.float64).ravel()
        b = b[np.argsort(-s)][:max_num_box]
        for ann in record.get("annotations", []):
            gt = np.asarray(ann["bbox"], np.float64)
            iw = np.maximum(np.minimum(b[:, 2], gt[2]) - np.maximum(b[:, 0], gt[0]) + 1.0, 0.0)
            ih = np.maximum(np.minimum(b[:, 3], gt[3]) - np.maximum(b[:, 1], gt[1]) + 1.0, 0.0)
            inter = iw * ih
            uni = ((gt[2] - gt[0] + 1.0) * (gt[3] - gt[1] + 1.0)
                   + (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0) - inter)
            ovmax = float(np.max(inter / uni)) if len(b) else 0.0
            cnt_gt += 1
            for t, thr in enumerate(iou_thresholds):
                if ovmax >= thr:
                    cnt_yes[t] += 1
    return [float(y) / max(cnt_gt, 1) for y in cnt_yes]


def main(argv=None):
    from ..data.catalog import DatasetCatalog
    from ..data.datasets.builtin_extra import register_all_extra
    from ..data.datasets.coco import register_all_coco
    from ..data.datasets.voc import register_all_voc

    argv = argv if argv is not None else sys.argv[1:]
    mode, dataset_name, path_in, file_out = argv[:4]
    register_all_voc()
    register_all_coco()
    register_all_extra()
    dicts = DatasetCatalog.get(dataset_name)
    if mode == "ss":
        out = convert_ss_box(dataset_name, dicts, path_in)
    elif mode == "mcg":
        out = convert_mcg_box(dataset_name, dicts, path_in)
    else:
        raise SystemExit(f"unknown mode {mode} (ss|mcg)")
    with open(file_out, "wb") as f:
        pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
    print(f"wrote {len(out['boxes'])} images -> {file_out}")


if __name__ == "__main__":
    main()
