"""The port's COCO-format sets and evaluator (sos_wsod_torch/data/datasets/
coco.py, builtin_extra.py, evaluation/coco_eval.py) against the JAX
package's, and against the reference's C++ COCOeval golden.

Tolerances: both evaluators are float64 numpy on the same inputs in the
same order, so their results are held exactly equal (NaN where both are
NaN), and their detection-result dumps byte for byte. Against the golden
(tests/goldens/cocoeval.npz, recorded from the reference's own C++
COCOeval) the summary is held within 1e-10, as the JAX package's own test
holds it. The loaders are held to exactly equal dicts.
"""
from __future__ import annotations

import json
import math
import pathlib

import numpy as np
import pytest

from sos_wsod_torch.data.catalog import DatasetCatalog, MetadataCatalog
from sos_wsod_torch.data.datasets import builtin_extra, coco
from sos_wsod_torch.evaluation.coco_eval import COCOEvaluator, bbox_iou_xyxy
from sos_wsod_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from sos_wsod_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from sos_wsod_tpu.data.datasets import builtin_extra as jax_builtin_extra
from sos_wsod_tpu.data.datasets import coco as jax_coco
from sos_wsod_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from sos_wsod_tpu.evaluation.coco_eval import bbox_iou_xyxy as jax_bbox_iou_xyxy

GOLD = pathlib.Path(__file__).resolve().parent / "goldens"


def _same_results(a, b):
    assert list(a) == list(b) and list(a["bbox"]) == list(b["bbox"])
    for k, v in a["bbox"].items():
        w = b["bbox"][k]
        assert (math.isnan(v) and math.isnan(w)) or v == w, (k, v, w)


def _synthetic(rng, n_images=6, n_classes=4):
    """Ground truth with crowd boxes and areas on the small/medium/large
    edges (32^2 and 96^2 exactly), and detections near them: one image
    gets 130 detections of a class (the 100-a-image cut), ties of score
    too."""
    anns, dets = {}, []
    for img in range(n_images):
        g = rng.integers(1, 6)
        xy = rng.uniform(0, 200, (g, 2))
        side = rng.choice([32.0, 96.0, 20.0, 60.0, 150.0], g)
        boxes = np.concatenate([xy, xy + side[:, None]], 1)
        anns[img] = {"boxes": boxes, "classes": rng.integers(0, n_classes, g),
                     "areas": side ** 2, "crowd": rng.random(g) < 0.25}
        n = 130 if img == 2 else int(rng.integers(0, 12))
        for _ in range(n):
            j = rng.integers(0, g)
            jitter = rng.normal(0, 6, 4) if rng.random() < 0.7 else rng.uniform(-80, 80, 4)
            b = boxes[j] + jitter
            b[2:] = np.maximum(b[2:], b[:2] + 1)
            cls = anns[img]["classes"][j] if rng.random() < 0.8 else rng.integers(0, n_classes)
            dets.append((img, b, round(float(rng.random()), 2), int(cls)))
    return anns, dets


def _run(cls, anns, dets, **kw):
    ev = cls("synthetic", annotations=anns, **kw)
    for img in sorted({d[0] for d in dets}):
        mine = [d for d in dets if d[0] == img]
        ev.process_single(img, [d[1] for d in mine], [d[2] for d in mine], [d[3] for d in mine],
                          np.arange(len(mine)) % 7 != 3)
    return ev.evaluate()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_equals_jax(seed, tmp_path):
    """Crowd regions, area-range edges, the maxDets cut, invalid rows and
    classes without ground truth: the same AP, AP50, AP75, APs, APm, APl,
    and byte-identical detection-result dumps."""
    anns, dets = _synthetic(np.random.default_rng(seed))
    got = _run(COCOEvaluator, anns, dets, num_classes=5, save_detection_result=True,
               save_path=str(tmp_path / "torch_{}.json"))
    want = _run(JaxCOCOEvaluator, anns, dets, num_classes=5, save_detection_result=True,
                save_path=str(tmp_path / "jax_{}.json"))
    _same_results(got, want)
    assert not math.isnan(got["bbox"]["AP"])
    assert (tmp_path / "torch_synthetic.json").read_bytes() == \
        (tmp_path / "jax_synthetic.json").read_bytes()
    # num_classes taken from the annotations
    _same_results(_run(COCOEvaluator, anns, dets), _run(JaxCOCOEvaluator, anns, dets))


def test_bbox_iou_equals_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 50, (7, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (5, 4))
    b[:, 2:] += b[:, :2]
    b[0] = [3, 3, 3, 9]   # zero area
    np.testing.assert_array_equal(bbox_iou_xyxy(a, b), jax_bbox_iou_xyxy(a, b))
    assert bbox_iou_xyxy(a[:0], b).shape == (0, 5)


def test_evaluate_matches_reference_cpp_golden():
    """The golden's dataset (crowd ground truth, area ranges, maxDets
    truncation, score ties, empty cells) against the reference's C++
    COCOeval summary."""
    z = np.load(GOLD / "cocoeval.npz")
    img_ids = [int(i) for i in z["img_ids"]]
    gmeta, gboxes = z["gt_meta"], z["gt_boxes_xywh"]
    dmeta, dboxes = z["dt_meta"], z["dt_boxes_xywh"]

    def xyxy(xywh):
        return np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1)

    annotations = {}
    for img in img_ids:
        sel = gmeta[:, 1] == img
        annotations[img] = {"boxes": xyxy(gboxes[sel]),
                            "classes": gmeta[sel, 2].astype(np.int64) - 1,
                            "areas": gboxes[sel, 2] * gboxes[sel, 3],
                            "crowd": gmeta[sel, 3].astype(bool)}
    ev = COCOEvaluator("golden", annotations=annotations, num_classes=3)
    for img in img_ids:
        sel = dmeta[:, 1] == img
        ev.process_single(img, xyxy(dboxes[sel]), dmeta[sel, 3], dmeta[sel, 2].astype(np.int64) - 1)
    res = ev.evaluate()["bbox"]
    got = np.array([res[k] for k in ("AP", "AP50", "AP75", "APs", "APm", "APl")]) / 100.0
    stats = z["stats"]
    np.testing.assert_allclose(got, np.where(stats[:6] == -1, np.nan, stats[:6]), rtol=0,
                               atol=1e-10)


def _coco_tree(root, rng):
    c = root / "datasets" / "coco"
    (c / "annotations").mkdir(parents=True)
    (c / "pseudo_labels").mkdir()
    cats = [{"id": i, "name": f"c{i}"} for i in (90, 2, 17, 5)]
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "height": 40 + i, "width": 70 + i}
              for i in (4, 9, 16, 25)]
    anns = [{"id": k + 1, "image_id": int(rng.choice([4, 9, 16])),
             "category_id": int(rng.choice([90, 2, 17, 5])),
             "bbox": [float(v) for v in np.round(rng.uniform(1, 30, 4), 2)],
             "iscrowd": int(k % 5 == 0)} for k in range(12)]
    anns[3].pop("iscrowd")
    anns[4]["area"] = 123.5
    for name in ("instances_train2014.json", "instances_minival2014.json"):
        (c / "annotations" / name).write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": cats}))
    (c / "annotations" / "image_info_unlabeled2017.json").write_text(
        json.dumps({"images": images[:2]}))
    pseudo = {"4": [{"category_id": 3, "bbox": [1.7, 2.2, 30.9, 20.5], "score": 0.5}],
              "16": [], "multi_label": {"4": [3], "16": [0, 1]}}
    (c / "pseudo_labels" / "oicr_plus_coco_2014_train.json").write_text(json.dumps(pseudo))
    pseudo.pop("multi_label")
    (c / "pseudo_labels" / "oicr_plus_coco_2014_minival.json").write_text(json.dumps(pseudo))


def _remove_coco_and_extra():
    for cat in (DatasetCatalog, JaxDatasetCatalog):
        for name in cat.list():
            if "coco" in name or "flickr" in name or "pgt" in name or "instance" in name:
                cat.remove(name)


@pytest.fixture()
def catalogs():
    """Both catalogs without the names the COCO and extra registrations add
    (other tests of the process, the CLIs among them, may have registered
    them under another root), before the test and after it."""
    _remove_coco_and_extra()
    yield
    _remove_coco_and_extra()


def test_loaders_and_registrations_equal_jax(tmp_path, monkeypatch, catalogs):
    """load_coco_json (non-contiguous category ids, crowd flags, a missing
    area), the _wsl pseudo-label variant with and without multi_label,
    the unlabeled set, and each set register_all_extra names (with
    $wsl_DATASETS): the same dicts and metadata as the JAX loaders."""
    _coco_tree(tmp_path, np.random.default_rng(0))
    monkeypatch.chdir(tmp_path)
    jf = "datasets/coco/annotations/instances_train2014.json"
    assert coco.load_coco_json(jf, "img", "t") == jax_coco.load_coco_json(jf, "img", "t")
    assert vars(MetadataCatalog.get("t")) == vars(JaxMetadataCatalog.get("t"))
    coco.register_all_coco()
    jax_coco.register_all_coco()
    for name in ("coco_2014_train", "coco_2014_train_wsl", "coco_2014_minival_wsl",
                 "coco_2017_unlabel"):
        got, want = DatasetCatalog.get(name), JaxDatasetCatalog.get(name)
        assert got == want and len(got) > 0, name
        assert vars(MetadataCatalog.get(name)) == vars(JaxMetadataCatalog.get(name)), name
    wsl = DatasetCatalog.get("coco_2014_train_wsl")
    assert [d["image_id"] for d in wsl] == [4, 16]
    assert wsl[0]["annotations"][0]["bbox"] == [1, 2, 30, 20]
    assert wsl[1]["multi_label"] == [0, 1]
    assert {n for n in DatasetCatalog.list() if "coco" in n} == \
        {n for n in JaxDatasetCatalog.list() if "coco" in n}

    monkeypatch.setenv("wsl_DATASETS", "elsewhere")
    builtin_extra.register_all_extra()
    jax_builtin_extra.register_all_extra()
    names = [n for n in JaxDatasetCatalog.list() if "flickr" in n or "pgt" in n or "instance" in n]
    assert len(names) == 9 and set(names) <= set(DatasetCatalog.list())
    for name in names:
        assert vars(MetadataCatalog.get(name)) == vars(JaxMetadataCatalog.get(name)), name
    assert MetadataCatalog.get("flickr_coco").json_file == "elsewhere/flickr_coco/images.json"
    assert len(MetadataCatalog.get("flickr_coco").thing_classes) == 80
