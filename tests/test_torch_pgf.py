"""The port's stage-1 -> stage-2 hand-off tools (sos_wsod_torch/tools/pgf.py,
add_multi_label.py and the COCO flavours in data/datasets/coco.py) against
the JAX package's, on the same seeded detections.

Tolerance: none. The filters are list manipulation on the same Python
floats, so the filtered detections, the printed counts and the written
JSON files are held equal, the files byte for byte.
"""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest

from sos_wsod_torch.engine.synthetic import write_synthetic_voc
from sos_wsod_torch.tools import add_multi_label, pgf
from sos_wsod_tpu.tools import add_multi_label as jax_add_multi_label
from sos_wsod_tpu.tools import pgf as jax_pgf

SPLITS = (("train", 5), ("val", 3), ("test", 1))


def _box(rng, w=80, h=60):
    x1, y1 = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
    return [x1, y1, x1 + rng.uniform(4, w - x1), y1 + rng.uniform(4, h - y1)]


def _detections(rng, image_ids, classes=range(20), per_image=12):
    """Stage-1 dump records (1-based category ids, rounded as the evaluator
    rounds them) with, in each image, a containment chain of one class
    (each box inside the one before), duplicates of one class with scores
    across t_keep, a "difficult" class (bottle), and random others."""
    recs = []
    for img in image_ids:
        c_chain, c_dup = (int(c) for c in rng.choice(list(classes), 2, replace=False))
        x1, y1, x2, y2 = _box(rng)
        for k in range(3):   # nested: 20%, 10%, 5% in from each side
            dx, dy = (x2 - x1) * 0.05 * k, (y2 - y1) * 0.05 * k
            recs.append((img, c_chain, rng.uniform(0, 1), [x1 + dx, y1 + dy, x2 - dx, y2 - dy]))
        for score in (0.9, 0.25, 0.15, 0.2):
            recs.append((img, c_dup, score, _box(rng)))
        outer = _box(rng)
        recs.append((img, 4, 0.5, outer))
        recs.append((img, 4, 0.4, [outer[0] + 1, outer[1] + 1, outer[2] - 1, outer[3] - 1]))
        for _ in range(per_image - 9):
            recs.append((img, int(rng.choice(list(classes))), rng.uniform(0, 1), _box(rng)))
    rng.shuffle(recs)
    return [{"image_id": int(img), "category_id": c + 1, "score": round(float(s), 3),
             "bbox": [round(float(v), 1) for v in b]} for img, c, s, b in recs]


def _dataset_dicts(rng, image_ids):
    """Dataset dicts labelled with 1-3 classes each (bottle in every other
    image); the last image's classes match no detection of it."""
    out = []
    for k, img in enumerate(image_ids):
        classes = [int(c) for c in rng.choice(20, rng.randint(1, 4), replace=False)]
        if k % 2:
            classes.append(4)
        if k == len(image_ids) - 1:
            classes = [19]
        out.append({"image_id": f"{img:06d}",
                    "annotations": [{"category_id": c, "bbox": [0, 0, 1, 1]} for c in classes]})
    return out


def _both(fn_name, *args):
    """fn_name of each package on its own deep copy of ``args``; returns
    the mutated copies and the return values."""
    out = []
    for mod in (pgf, jax_pgf):
        a = copy.deepcopy(args)
        out.append((a, getattr(mod, fn_name)(*a)))
    return out


def test_contain_cal_matches_jax():
    """XYXY boxes read as XYWH, as in the reference."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b = _box(rng), _box(rng)
        assert pgf.contain_cal(a, b) == jax_pgf.contain_cal(a, b)
        assert pgf.contain_cal(a, a) == jax_pgf.contain_cal(a, a)
    a = [10, 10, 20, 20]
    assert pgf.contain_cal(a, [0, 0, 40, 40]) == jax_pgf.contain_cal(a, [0, 0, 40, 40])
    assert a == [10, 10, 20, 20]   # the inputs are not modified


@pytest.mark.parametrize("use_diff", [False, True])
@pytest.mark.parametrize("t_con,t_keep", [(0.85, 0.2), (0.5, 0.1)])
def test_filters_match_jax(use_diff, t_con, t_keep, capsys):
    """build_result_and_labels, class_filter and pgf on seeded detections of
    6 images (one of them in no dataset dict, one with no record, one
    whose every detection is dropped): the same result, the same shifted
    input records and the same printed counts."""
    rng = np.random.default_rng(7)
    ids = list(range(1, 7))
    dicts = _dataset_dicts(np.random.RandomState(3), ids)
    dets = _detections(rng, [1, 2, 3, 4, 6, 99], classes=range(19))
    (mine, (res, cls)), (theirs, (jres, jcls)) = _both("build_result_and_labels", dicts, dets)
    assert (res, cls) == (jres, jcls) and mine == theirs
    assert 5 not in res and 99 not in res
    assert mine[1][0]["category_id"] == dets[0]["category_id"] - 1
    capsys.readouterr()
    runs = []
    for mod in (pgf, jax_pgf):
        r = copy.deepcopy(res)
        mod.class_filter(r, cls, "train")
        mod.pgf(r, "train", t_con, t_keep, use_diff, mod.DIFF_CLASSES)
        runs.append((r, capsys.readouterr().out))
    assert runs[0] == runs[1]
    r = runs[0][0]
    assert set(r) == {1, 2, 3, 4, 6} and r[6] == []
    assert sum(map(len, r.values())) < sum(map(len, res.values()))
    # the class filter keeps only labelled classes; pgf kept something
    assert all(d["category_id"] in cls[i] for i, v in r.items() for d in v)
    assert sum(map(len, r.values())) > 0


def _write_dets(path, dets):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dets))


@pytest.fixture()
def voc_tree(tmp_path, monkeypatch):
    """A synthetic VOC tree (cwd) with a stage-1 detection JSON of its train
    and val splits; the last val image has no detection record."""
    ids = write_synthetic_voc(str(tmp_path), SPLITS, (60, 80), 4, seed=2)
    rng = np.random.default_rng(5)
    det_dir = tmp_path / "datasets" / "VOC2007" / "detection_results"
    for split in ("train", "val"):
        img = [int(i) for i in ids[split]][:-1 if split == "val" else None]
        _write_dets(det_dir / f"oicr_plus_voc_2007_{split}.json", _detections(rng, img))
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("flags", [[], ["--use-diff", "--t-con", "0.6", "--t-keep", "0.3"]])
def test_pgf_and_multi_label_mains_byte_identical(voc_tree, flags, capsys):
    """pgf.main then add_multi_label.main of each package on the same
    detection JSONs: the files are byte-identical after each tool."""
    det = "datasets/VOC2007/detection_results/"
    for name, mod, ml in (("torch", pgf, add_multi_label), ("jax", jax_pgf, jax_add_multi_label)):
        mod.main(["--det-path", det, "--save-path", f"out_{name}", *flags])
        for split in ("train", "val"):
            (voc_tree / f"out_{name}" / f"pgf_{split}.json").write_bytes(
                (voc_tree / f"out_{name}" / f"oicr_plus_voc_2007_{split}.json").read_bytes())
        ml.main(["--pgt-temp", f"out_{name}/oicr_plus_voc_2007_{{}}.json"])
    out = capsys.readouterr().out
    assert out.count("train split length after pgf") == 2
    for split in ("train", "val"):
        for stem in ("pgf", "oicr_plus_voc_2007"):
            got = (voc_tree / "out_torch" / f"{stem}_{split}.json").read_bytes()
            assert got == (voc_tree / "out_jax" / f"{stem}_{split}.json").read_bytes()
    val = json.loads((voc_tree / "out_torch" / "oicr_plus_voc_2007_val.json").read_text())
    assert len(val["multi_label"]) == 3 and len(val) == 3   # the image without records: no key


def _coco_json(rng, image_ids, cat_ids):
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "height": 60, "width": 80}
              for i in image_ids]
    anns = []
    for i in image_ids:
        for c in rng.choice(cat_ids, rng.integers(1, 4), replace=False):
            x, y, w, h = (round(float(v), 2) for v in rng.uniform(1, 30, 4))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": int(c),
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": int(rng.random() < 0.2)})
    cats = [{"id": int(c), "name": f"c{c}"} for c in sorted(cat_ids, reverse=True)]
    return {"images": images, "annotations": anns, "categories": cats}


@pytest.fixture()
def coco_catalogs():
    """The COCO sets, removed from both catalogs after the test."""
    yield
    from sos_wsod_torch.data.catalog import DatasetCatalog
    from sos_wsod_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog

    for cat in (DatasetCatalog, JaxDatasetCatalog):
        for name in cat.list():
            if name.startswith("coco_"):
                cat.remove(name)


def test_coco_pgf_and_multi_label_byte_identical(tmp_path, monkeypatch, coco_catalogs):
    """--dataset coco on a tiny COCO tree (non-contiguous category ids, crowd
    annotations): both tools' files byte-identical to the JAX tools'."""
    rng = np.random.default_rng(11)
    cat_ids = np.array([1, 3, 7, 8, 13, 20, 42, 90])
    ann_dir = tmp_path / "datasets" / "coco" / "annotations"
    ann_dir.mkdir(parents=True)
    splits = {"coco_2014_train": ("instances_train2014.json", [3, 5, 8, 13]),
              "coco_2014_valminusminival": ("instances_valminusminival2014.json", [21, 34])}
    for split, (fname, ids) in splits.items():
        (ann_dir / fname).write_text(json.dumps(_coco_json(rng, ids, cat_ids)))
        # contiguous 1-based ids, as the COCO evaluator's dump writes them
        _write_dets(tmp_path / "dets" / f"oicr_plus_{split}.json",
                    _detections(rng, ids, classes=range(len(cat_ids)), per_image=10))
    monkeypatch.chdir(tmp_path)
    for name, mod, ml in (("torch", pgf, add_multi_label), ("jax", jax_pgf, jax_add_multi_label)):
        mod.main(["--dataset", "coco", "--det-path", "dets", "--save-path", f"out_{name}",
                  "--coco-path", "datasets/coco/"])
        stems = {f"oicr_plus_{s}.json": f"pgf_{s}.json" for s in splits}
        for src, dst in stems.items():
            out = tmp_path / f"out_{name}"
            (out / dst).write_bytes((out / src).read_bytes())
        ml.main(["--dataset", "coco", "--pgt-temp", f"out_{name}/oicr_plus_coco_2014_{{}}.json"])
    for f in sorted(p.name for p in (tmp_path / "out_jax").iterdir()):
        got = (tmp_path / "out_torch" / f).read_bytes()
        assert got == (tmp_path / "out_jax" / f).read_bytes(), f
    train = json.loads((tmp_path / "out_torch" / "oicr_plus_coco_2014_train.json").read_text())
    assert set(train["multi_label"]) == {"3", "5", "8", "13"}
    assert sum(len(v) for k, v in train.items() if k != "multi_label") > 0
