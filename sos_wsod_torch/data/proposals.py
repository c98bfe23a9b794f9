"""Precomputed proposals (MCG, selective search) from detectron2 pickles.

Counterpart of ``sos_wsod_tpu/data/proposals.py`` (detectron2's
``load_proposals_into_dataset``): a pickle with the keys {ids | indexes,
boxes, objectness_logits | scores, bbox_mode} is matched to the dataset dicts
by image id, and each dict gains proposal_boxes and
proposal_objectness_logits, sorted by objectness, highest first.
"""
from __future__ import annotations

import pickle
from typing import List

import numpy as np

XYXY_ABS = 0  # detectron2's BoxMode.XYXY_ABS


def load_proposals_into_dataset(dataset_dicts: List[dict], proposal_file: str) -> List[dict]:
    with open(proposal_file, "rb") as f:
        proposals = pickle.load(f, encoding="latin1")
    for old, new in (("indexes", "ids"), ("scores", "objectness_logits")):
        if old in proposals:
            proposals[new] = proposals.pop(old)
    if proposals.get("bbox_mode", XYXY_ABS) != XYXY_ABS:
        raise ValueError(f"{proposal_file}: only XYXY_ABS proposal boxes are supported")
    id_to_index = {str(pid): i for i, pid in enumerate(proposals["ids"])}
    out = []
    for d in dataset_dicts:
        d = dict(d)
        i = id_to_index[str(d["image_id"])]
        boxes = np.asarray(proposals["boxes"][i], dtype=np.float32)
        logits = np.asarray(proposals["objectness_logits"][i], dtype=np.float32)
        order = logits.argsort()[::-1]
        d["proposal_boxes"] = boxes[order]
        d["proposal_objectness_logits"] = logits[order]
        d["proposal_bbox_mode"] = XYXY_ABS
        out.append(d)
    return out


def save_proposals(path: str, ids, boxes, objectness_logits) -> None:
    """Write a detectron2-format proposal pickle."""
    with open(path, "wb") as f:
        pickle.dump({"ids": list(ids), "boxes": list(boxes),
                     "objectness_logits": list(objectness_logits), "bbox_mode": XYXY_ABS}, f)
