"""Add each image's label classes to the pseudo-label JSONs.

Counterpart of ``sos_wsod_tpu/tools/add_multi_label.py`` (the reference's
tools/add_multi_label.py): a top-level ``multi_label`` mapping {str(image
id): [class ids in first-seen order]} is added to each PGF output file. The
``_wsl`` loaders attach it to the dataset dicts, and stage 3's pseudo-box
filter reads it. The files are byte-identical to the JAX tool's.

    python -m sos_wsod_torch.tools.add_multi_label \\
        [--pgt-temp datasets/VOC2007/pseudo_labels/oicr_plus_voc_2007_{}.json] [--dataset ...]
"""
from __future__ import annotations

import json
from typing import Dict, List


def get_multi_class_label(dataset: List[dict]) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {}
    for data in dataset:
        label: List[int] = []
        for ann in data["annotations"]:
            if ann["category_id"] not in label:
                label.append(ann["category_id"])
        out[str(int(data["image_id"]))] = label
    return out


def add_to_file(path: str, dataset: List[dict]) -> None:
    with open(path) as f:
        pgt = json.load(f)
    pgt["multi_label"] = get_multi_class_label(dataset)
    with open(path, "w") as f:
        json.dump(pgt, f)


def add_voc(pgt_temp: str, year: str, data_root: str = "datasets") -> None:
    from ..data.catalog import DatasetCatalog
    from ..data.datasets.voc import register_all_voc

    register_all_voc(data_root)
    for split in ("train", "val"):
        add_to_file(pgt_temp.format(split), DatasetCatalog.get(f"voc_{year}_{split}"))


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser("Adding multi-label messages into pseudo label files.")
    parser.add_argument(
        "--pgt-temp", default="datasets/VOC2007/pseudo_labels/oicr_plus_voc_2007_{}.json")
    parser.add_argument("--dataset", default="voc2007", choices=("voc2007", "voc2012", "coco"))
    parser.add_argument("--data-root", default="datasets")
    args = parser.parse_args(argv)

    if args.dataset == "coco":
        from ..data.datasets.coco import add_multi_label_coco

        add_multi_label_coco(args.pgt_temp)
    else:
        add_voc(args.pgt_temp, args.dataset[3:], args.data_root)


if __name__ == "__main__":
    main()
