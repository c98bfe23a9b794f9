"""VOC comp-style detection text files -> a COCO-format pseudo-ground-truth
JSON.

Counterpart of ``sos_wsod_tpu/tools/pgt_to_json.py`` (the reference's WSL
convert_voc2007_pgt_json.py): for each class, the first detection of each
image the class's ImageSets list marks positive becomes one COCO annotation
(1-based category id, integer XYWH box, iscrowd 0).

    python -m sos_wsod_torch.tools.pgt_to_json --det-tmpl DET_{}.txt \\
        --cls-tmpl ImageSets/Main/{}_train.txt --image-dir JPEGImages \\
        --split-txt ImageSets/Main/train.txt --out pgt.json
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Sequence

from ..data.voc import CLASS_NAMES as VOC_CLASSES

CATEGORIES = [{"supercategory": "none", "id": i + 1, "name": n}
              for i, n in enumerate(VOC_CLASSES)]


def read_positive_ids(cls_txt_path: str) -> List[str]:
    """The image ids marked 1 in a VOC ``<class>_<split>.txt``."""
    with open(cls_txt_path) as f:
        return [p[0] for p in (line.split() for line in f) if len(p) >= 2 and p[1] == "1"]


def detections_to_annotations(det_txt_tmpl: str, cls_txt_tmpl: str,
                              classes: Sequence[str] = VOC_CLASSES) -> List[dict]:
    """One annotation for each (positive image, class): the first line of
    the class's detection file (``img_id score x1 y1 x2 y2``) for that
    image."""
    annotations = []
    for ci, name in enumerate(classes):
        pos_ids = set(read_positive_ids(cls_txt_tmpl.format(name)))
        used = set()
        with open(det_txt_tmpl.format(name)) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                img_id = parts[0]
                x1, y1, x2, y2 = map(float, parts[2:6])
                if img_id not in pos_ids or img_id in used:
                    continue
                used.add(img_id)
                w, h = x2 - x1, y2 - y1
                annotations.append({"area": int(w * h), "image_id": img_id,
                                    "bbox": [int(x1), int(y1), int(w), int(h)], "iscrowd": 0,
                                    "category_id": ci + 1, "id": len(annotations)})
    return annotations


def image_infos(image_dir: str, ids: Sequence[str]) -> List[dict]:
    from PIL import Image

    infos = []
    for img_id in ids:
        with Image.open(os.path.join(image_dir, f"{img_id}.jpg")) as im:
            w, h = im.size
        infos.append({"file_name": f"{img_id}.jpg", "height": h, "width": w, "id": img_id})
    return infos


def build_coco_json(annotations: List[dict], images: List[dict]) -> dict:
    return {"images": images, "annotations": annotations, "categories": CATEGORIES,
            "type": "instance"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--det-tmpl", required=True,
                    help="detection txt template with {} for the class name")
    ap.add_argument("--cls-tmpl", required=True, help="VOC ImageSets Main txt template with {}")
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--split-txt", required=True,
                    help="ImageSets/Main/<split>.txt listing image ids")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    with open(args.split_txt) as f:
        ids = [line.split()[0] for line in f if line.strip()]
    anns = detections_to_annotations(args.det_tmpl, args.cls_tmpl)
    images = image_infos(args.image_dir, ids)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(build_coco_json(anns, images), f)
    print(f"wrote {len(anns)} annotations / {len(images)} images -> {args.out}")


if __name__ == "__main__":
    main()
