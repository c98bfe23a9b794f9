"""PGF: the pseudo-ground-truth filter from stage-1 detections to stage-2
labels.

Counterpart of ``sos_wsod_tpu/tools/pgf.py`` (the reference's tools/pgf.py):
the stage-1 evaluator's detection-result JSON is grouped by image, each
detection of a class the image is not labelled with is dropped, then the
two-pass filter keeps the first detection of each class, later ones only
with score >= ``t_keep``, and drops a box mostly contained in another box of
its class. The output JSON ({image id: [detections]}) is what
``data/datasets/voc.py:load_voc_instances_wsl`` reads; it is byte-identical
to the JAX tool's on the same input.

    python -m sos_wsod_torch.tools.pgf --det-path datasets/VOC2007/detection_results/ \\
        --save-path datasets/VOC2007/pseudo_labels/ [--dataset voc2007|voc2012|coco]
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List

# the VOC classes whose containment suppression is skipped unless
# --use-diff (bottle, bus, car, chair, cow, pottedplant, sheep)
DIFF_CLASSES = [4, 5, 6, 8, 9, 15, 16]


def contain_cal(a_, b_) -> float:
    """How much of box a lies inside box b. As in the reference, the XYXY
    boxes are read as XYWH: x1 and y1 are added to x2 and y2 first."""
    a = copy.deepcopy(a_)
    b = copy.deepcopy(b_)
    a[2] += a[0]
    a[3] += a[1]
    b[2] += b[0]
    b[3] += b[1]
    c = [max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])]
    area_c = max(0, c[2] - c[0]) * max(0, c[3] - c[1])
    area_a = max(0, a[2] - a[0]) * max(0, a[3] - a[1])
    return area_c / (area_a + 1e-6)


def _length(result: Dict) -> int:
    return sum(len(v) for v in result.values())


def class_filter(result: Dict, class_dict: Dict, split: str) -> None:
    """Drop, in place, the detections of a class the image is not labelled
    with."""
    print(f"{split} split length before multi-class filter: {_length(result)}")
    for img_id, predictions in result.items():
        gt_classes = class_dict[img_id]
        drop_list = [i for i, p in enumerate(predictions) if p["category_id"] not in gt_classes]
        for i in drop_list[::-1]:
            predictions.pop(i)
    print(f"{split} split length after multi-class filter: {_length(result)}")


def pgf(result: Dict, split: str, t_con: float, t_keep: float, use_diff: bool,
        diff_classes: List[int]) -> None:
    """The two passes, in place: (1) an image's first detection of each
    class is kept, a later one only with score >= ``t_keep``; (2) box i is
    dropped when ``contain_cal(i, j) >= t_con`` for another box j of its
    class (not for ``diff_classes`` unless ``use_diff``)."""
    print(f"{split} split length before pgf: {_length(result)}")
    for predictions in result.values():
        seen: List[int] = []
        drop_list = []
        for i, p in enumerate(predictions):
            if p["category_id"] not in seen:
                seen.append(p["category_id"])
            elif p["score"] < t_keep:
                drop_list.append(i)
        for i in drop_list[::-1]:
            predictions.pop(i)
    print(f"{split} split length in middle of pgf: {_length(result)}")

    for img_id in result:
        anns = result[img_id]
        save = [True] * len(anns)
        bboxes = [b["bbox"] for b in anns]
        cats = [b["category_id"] for b in anns]
        for b_i in range(len(save)):
            for b_j in range(len(save)):
                if b_i == b_j or cats[b_i] != cats[b_j]:
                    continue
                if not use_diff and cats[b_i] in diff_classes:
                    continue
                if contain_cal(bboxes[b_i], bboxes[b_j]) >= t_con:
                    save[b_i] = False
        result[img_id] = [copy.deepcopy(anns[j]) for j in range(len(save)) if save[j]]
    print(f"{split} split length after pgf: {_length(result)}")


def build_result_and_labels(dataset_dicts: List[dict], detection_result: List[dict]):
    """The detection-result records grouped by integer image id, each
    ``category_id`` shifted in place to 0-based (the records of images not
    in ``dataset_dicts`` are dropped; an image without a record gets no
    key), and each image's label classes in first-seen order."""
    gt_anns = {int(d["image_id"]): d["annotations"] for d in dataset_dicts}
    result: Dict[int, List[dict]] = {}
    for message in detection_result:
        message["category_id"] = message["category_id"] - 1
        if message["image_id"] in gt_anns:
            result.setdefault(message["image_id"], []).append(message)
    class_dict = {}
    for img_id, anns in gt_anns.items():
        classes: List[int] = []
        for ann in anns:
            if ann["category_id"] not in classes:
                classes.append(ann["category_id"])
        class_dict[img_id] = classes
    return result, class_dict


def filter_split(dataset_dicts: List[dict], det_file: str, save_file: str, split: str,
                 t_con: float, t_keep: float, use_diff: bool, diff_classes: List[int]) -> None:
    """One split: ``det_file`` through the class filter and PGF into
    ``save_file``."""
    with open(det_file) as f:
        detection_result = json.load(f)
    result, class_dict = build_result_and_labels(dataset_dicts, detection_result)
    class_filter(result, class_dict, split)
    pgf(result, split, t_con, t_keep, use_diff, diff_classes)
    with open(save_file, "w") as f:
        json.dump(result, f)


def pgf_voc(det_path: str, save_path: str, prefix: str, t_con: float, t_keep: float,
            use_diff: bool, year: str, data_root: str = "datasets") -> None:
    from ..data.catalog import DatasetCatalog
    from ..data.datasets.voc import register_all_voc

    register_all_voc(data_root)
    for split in ("train", "val"):
        name = f"voc_{year}_{split}"
        filter_split(DatasetCatalog.get(name), f"{det_path}/{prefix}{name}.json",
                     f"{save_path}/{prefix}{name}.json", split, t_con, t_keep, use_diff,
                     DIFF_CLASSES)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser("Perform PGF.")
    parser.add_argument("--det-path", default="datasets/VOC2007/detection_results/")
    parser.add_argument("--save-path", default="datasets/VOC2007/pseudo_labels/")
    parser.add_argument("--prefix", default="oicr_plus_")
    parser.add_argument("--dataset", default="voc2007", choices=("voc2007", "voc2012", "coco"))
    parser.add_argument("--coco-path", default="datasets/coco/")
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--t-con", default=0.85, type=float)
    parser.add_argument("--t-keep", default=0.2, type=float)
    parser.add_argument("--use-diff", action="store_true")
    args = parser.parse_args(argv)

    os.makedirs(args.save_path, exist_ok=True)
    if args.dataset == "coco":
        from ..data.datasets.coco import pgf_coco_datasets

        pgf_coco_datasets(args.det_path, args.save_path, args.prefix, args.t_con, args.t_keep,
                          args.use_diff, args.coco_path)
    else:
        pgf_voc(args.det_path, args.save_path, args.prefix, args.t_con, args.t_keep,
                args.use_diff, args.dataset[3:], args.data_root)


if __name__ == "__main__":
    main()
