"""Pascal VOC loaders: XML ground truth and the WSL pseudo-label JSON.

Counterpart of ``sos_wsod_tpu/data/datasets/voc.py`` (detectron2's
pascal_voc.py). Dataset dicts use detectron2's schema: file_name, image_id,
height, width, annotations [{category_id, bbox XYXY_ABS}], plus
``multi_label`` for the WSL pseudo-label sets.
"""
from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import List, Sequence

from ..catalog import DatasetCatalog, MetadataCatalog
from ..voc import CLASS_NAMES


def _read_split_ids(dirname: str, split: str) -> List[str]:
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        return [line.strip() for line in f if line.strip()]


def _image_size(dirname: str, fileid: str):
    from PIL import Image

    with Image.open(os.path.join(dirname, "JPEGImages", fileid + ".jpg")) as img:
        w, h = img.size
    return h, w


def _xml_size(tree: ET.ElementTree):
    return int(tree.findall("./size/height")[0].text), int(tree.findall("./size/width")[0].text)


def load_voc_instances(dirname: str, split: str, class_names: Sequence[str] = CLASS_NAMES):
    """VOC XML annotations -> dataset dicts. Difficult objects are skipped,
    and the 1-based inclusive pixel boxes shift to 0-based coordinates
    (x1, y1 minus 1). An image without an XML file gets no annotations."""
    dicts = []
    for fileid in _read_split_ids(dirname, split):
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        if not os.path.isfile(anno_file):
            h, w = _image_size(dirname, fileid)
            dicts.append({"file_name": jpeg_file, "image_id": fileid, "height": h, "width": w,
                          "annotations": []})
            continue
        tree = ET.parse(anno_file)
        h, w = _xml_size(tree)
        instances = []
        for obj in tree.findall("object"):
            if int(obj.find("difficult").text) == 1:
                continue
            bb = obj.find("bndbox")
            x1, y1, x2, y2 = (float(bb.find(x).text) for x in ("xmin", "ymin", "xmax", "ymax"))
            instances.append({"category_id": class_names.index(obj.find("name").text),
                              "bbox": [x1 - 1.0, y1 - 1.0, x2, y2]})
        dicts.append({"file_name": jpeg_file, "image_id": fileid, "height": h, "width": w,
                      "annotations": instances})
    return dicts


def load_voc_instances_wsl(dirname: str, split: str, class_names: Sequence[str] = CLASS_NAMES,
                           year: str = "2007"):
    """VOC images with the pseudo labels of
    ``pseudo_labels/oicr_plus_voc_{year}_{split}.json`` (the stage-1 ->
    stage-2 interface). Boxes are cast to int, as the reference does; the
    per-image ``multi_label`` is attached when the file has one."""
    path = os.path.join(dirname, "pseudo_labels", f"oicr_plus_voc_{year}_{split}.json")
    with open(path) as f:
        annotation_wsl = json.load(f)
    multi_label = annotation_wsl.pop("multi_label", None)
    dicts = []
    for fileid in _read_split_ids(dirname, split):
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        if os.path.isfile(anno_file):
            h, w = _xml_size(ET.parse(anno_file))
        else:
            h, w = _image_size(dirname, fileid)
        r = {"file_name": os.path.join(dirname, "JPEGImages", fileid + ".jpg"),
             "image_id": fileid, "height": h, "width": w,
             "annotations": [{"category_id": obj["category_id"],
                              "bbox": [int(i) for i in obj["bbox"]]}
                             for obj in annotation_wsl[str(int(fileid))]]}
        if multi_label is not None:
            r["multi_label"] = multi_label[str(int(fileid))]
        dicts.append(r)
    return dicts


def _register(name, loader, dirname, split, year, class_names):
    DatasetCatalog.register(name, loader)
    MetadataCatalog.get(name).set(thing_classes=list(class_names), dirname=dirname, year=year,
                                  split=split, evaluator_type="pascal_voc")


def register_pascal_voc(name, dirname, split, year, class_names=CLASS_NAMES):
    _register(name, lambda: load_voc_instances(dirname, split, class_names),
              dirname, split, year, class_names)


def register_pascal_voc_wsl(name, dirname, split, year, class_names=CLASS_NAMES):
    _register(name, lambda: load_voc_instances_wsl(dirname, split, class_names, str(year)),
              dirname, split, year, class_names)


def register_all_voc(root: str = "datasets"):
    """voc_{2007,2012}_{train,val,trainval,test} and their ``_wsl``
    pseudo-label variants under ``root``/VOC{year}; names already registered
    are left as they are."""
    for year in ("2007", "2012"):
        dirname = os.path.join(root, f"VOC{year}")
        for split in ("train", "val", "trainval", "test"):
            name = f"voc_{year}_{split}"
            if name not in DatasetCatalog:
                register_pascal_voc(name, dirname, split, year)
            if f"{name}_wsl" not in DatasetCatalog:
                register_pascal_voc_wsl(f"{name}_wsl", dirname, split, year)
