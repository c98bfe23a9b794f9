"""COCO-format JSON datasets (plain json, no pycocotools).

Counterpart of ``sos_wsod_tpu/data/datasets/coco.py`` (detectron2's
load_coco_json and register_coco_instances, and ubteacher's pseudo-label
and unlabeled COCO sets). Dataset dicts use detectron2's schema with XYXY
boxes; category ids are mapped to contiguous 0-based ids in the order of
their sorted dataset ids; crowd annotations are kept (the evaluator ignores
them). Also the COCO flavours of PGF and of the multi-label tool.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog

# the 80 thing classes in contiguous order
COCO_CLASS_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


def load_coco_json(json_file: str, image_root: str,
                   dataset_name: Optional[str] = None) -> List[dict]:
    """A COCO instances JSON -> dataset dicts; with ``dataset_name``, its
    metadata gets the class names and the id map."""
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(
            thing_classes=[c["name"] for c in cats], thing_dataset_id_to_contiguous_id=id_map,
            json_file=json_file, image_root=image_root)

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)
    dicts = []
    for img in coco["images"]:
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            x, y, w, h = ann["bbox"]   # XYWH -> XYXY
            objs.append({"category_id": id_map.get(ann["category_id"], ann["category_id"]),
                         "bbox": [x, y, x + w, y + h], "iscrowd": ann.get("iscrowd", 0),
                         "area": ann.get("area", w * h)})
        dicts.append({"file_name": os.path.join(image_root, img["file_name"]),
                      "image_id": img["id"], "height": img["height"], "width": img["width"],
                      "annotations": objs})
    return dicts


def load_coco_instances_wsl(json_file: str, image_root: str,
                            pseudo_label_file: str) -> List[dict]:
    """The images of a COCO JSON that have a key in the PGF output
    {image id: [detections]}, with those detections (boxes cast to int) as
    annotations and the file's ``multi_label`` entry when it has one."""
    dicts = load_coco_json(json_file, image_root)
    with open(pseudo_label_file) as f:
        pseudo = json.load(f)
    multi_label = pseudo.pop("multi_label", None)
    out = []
    for d in dicts:
        key = str(d["image_id"])
        if key not in pseudo:
            continue
        r = dict(d)
        r["annotations"] = [{"category_id": obj["category_id"],
                             "bbox": [int(i) for i in obj["bbox"]]} for obj in pseudo[key]]
        if multi_label is not None:
            r["multi_label"] = multi_label.get(key, [])
        out.append(r)
    return out


def _coco_meta(name: str, json_file: str, image_root: str) -> None:
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root,
                                  evaluator_type="coco")


def register_coco_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    _coco_meta(name, json_file, image_root)


def register_coco_instances_wsl(name: str, json_file: str, image_root: str,
                                pseudo_label_file: str):
    DatasetCatalog.register(
        name, lambda: load_coco_instances_wsl(json_file, image_root, pseudo_label_file))
    _coco_meta(name, json_file, image_root)


def register_coco_unlabel(name: str, json_file: str, image_root: str):
    """An image-info JSON without annotations (ubteacher's unlabeled COCO)."""

    def load():
        with open(json_file) as f:
            coco = json.load(f)
        return [{"file_name": os.path.join(image_root, img["file_name"]), "image_id": img["id"],
                 "height": img["height"], "width": img["width"], "annotations": []}
                for img in coco["images"]]

    DatasetCatalog.register(name, load)
    _coco_meta(name, json_file, image_root)


def register_all_coco(root: str = "datasets"):
    """coco_2014_{train,valminusminival,minival} and coco_2017_{train,val},
    each with its ``_wsl`` pseudo-label variant
    (``coco/pseudo_labels/oicr_plus_{name}.json``), and coco_2017_unlabel,
    under ``root``/coco; names already registered are left as they are."""
    c = os.path.join(root, "coco")
    specs = [
        ("coco_2014_train", "annotations/instances_train2014.json", "train2014"),
        ("coco_2014_valminusminival", "annotations/instances_valminusminival2014.json",
         "val2014"),
        ("coco_2014_minival", "annotations/instances_minival2014.json", "val2014"),
        ("coco_2017_train", "annotations/instances_train2017.json", "train2017"),
        ("coco_2017_val", "annotations/instances_val2017.json", "val2017"),
    ]
    for name, jf, ir in specs:
        if name not in DatasetCatalog:
            register_coco_instances(name, os.path.join(c, jf), os.path.join(c, ir))
        if name + "_wsl" not in DatasetCatalog:
            register_coco_instances_wsl(name + "_wsl", os.path.join(c, jf), os.path.join(c, ir),
                                        os.path.join(c, "pseudo_labels", f"oicr_plus_{name}.json"))
    if "coco_2017_unlabel" not in DatasetCatalog:
        register_coco_unlabel("coco_2017_unlabel",
                              os.path.join(c, "annotations/image_info_unlabeled2017.json"),
                              os.path.join(c, "unlabeled2017"))


def pgf_coco_datasets(det_path, save_path, prefix, t_con, t_keep, use_diff, coco_path):
    """PGF over coco_2014_train and coco_2014_valminusminival, registered
    under the parent of ``coco_path``; COCO has no "difficult" classes."""
    from ...tools.pgf import filter_split

    register_all_coco(os.path.dirname(coco_path.rstrip("/")) or "datasets")
    for split in ("coco_2014_train", "coco_2014_valminusminival"):
        filter_split(DatasetCatalog.get(split), f"{det_path}/{prefix}{split}.json",
                     f"{save_path}/{prefix}{split}.json", split, t_con, t_keep, use_diff, [])


def add_multi_label_coco(pgt_temp: str):
    """The multi-label tool on ``pgt_temp`` formatted with "train" and
    "valminusminival", from the COCO sets under ./datasets."""
    from ...tools.add_multi_label import add_to_file

    register_all_coco()
    for split, fmt in (("coco_2014_train", "train"),
                       ("coco_2014_valminusminival", "valminusminival")):
        add_to_file(pgt_temp.format(fmt), DatasetCatalog.get(split))
