"""The extra WSL datasets: Flickr web images, VOC-PGT and VOC-SBD.

Counterpart of ``sos_wsod_tpu/data/datasets/builtin_extra.py`` (the
reference's WSL builtin.py): COCO-format JSON sets under ``./datasets``, or
under ``$wsl_DATASETS`` when it is set. Loading is lazy, so they register
without their files.
"""
from __future__ import annotations

import os

from ..catalog import DatasetCatalog, MetadataCatalog
from ..voc import CLASS_NAMES as VOC_CLASS_NAMES
from .coco import COCO_CLASS_NAMES, register_coco_instances

# name: (image root, json file, class names), relative to the root
_FLICKR = {
    "flickr_voc": ("flickr_voc/images", "flickr_voc/images.json", "voc"),
    "flickr_coco": ("flickr_coco/images", "flickr_coco/images.json", "coco"),
}
_VOC_PGT = {
    "voc_2007_train_pgt": ("VOC2007/JPEGImages",
                           "VOC2007/../results/VOC2007/Main/voc_2007_train_pgt.json", "voc"),
    "voc_2007_val_pgt": ("VOC2007/JPEGImages",
                         "VOC2007/../results/VOC2007/Main/voc_2007_val_pgt.json", "voc"),
}
_VOC_SBD = {
    "voc_2012_train_instance": ("VOC_SBD/images",
                                "VOC_SBD/annotations/voc_2012_train_instance.json", "voc"),
    "voc_2012_val_instance": ("VOC_SBD/images",
                              "VOC_SBD/annotations/voc_2012_val_instance.json", "voc"),
    "sbd_9118_instance": ("VOC_SBD/images", "VOC_SBD/annotations/sbd_9118_instance.json", "voc"),
    "voc_2012_train_instance_pgt": ("VOC_SBD/images",
                                    "VOC_SBD/annotations/voc_2012_train_instance_pgt.json", "voc"),
    "sbd_9118_instance_pgt": ("VOC_SBD/images",
                              "VOC_SBD/annotations/sbd_9118_instance_pgt.json", "voc"),
}


def _register_group(specs, root: str):
    for name, (image_root, json_file, kind) in specs.items():
        if name in DatasetCatalog:
            continue
        register_coco_instances(name, os.path.join(root, json_file),
                                os.path.join(root, image_root))
        MetadataCatalog.get(name).set(
            thing_classes=list(VOC_CLASS_NAMES if kind == "voc" else COCO_CLASS_NAMES))


def register_all_web(root: str = "datasets"):
    _register_group(_FLICKR, root)


def register_all_voc_pgt(root: str = "datasets"):
    _register_group(_VOC_PGT, root)


def register_all_voc_sbd(root: str = "datasets"):
    _register_group(_VOC_SBD, root)


def register_all_extra(root: str = "datasets"):
    root = os.getenv("wsl_DATASETS", root)
    register_all_web(root)
    register_all_voc_pgt(root)
    register_all_voc_sbd(root)
