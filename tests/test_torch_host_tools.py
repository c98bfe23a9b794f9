"""The port's host tools (sos_wsod_torch/tools/pgt_to_json.py,
proposals_convert.py, filter_metrics.py and visualize.py) against the JAX
package's, on the same seeded inputs.

Tolerance: none. The tools are the same numpy, json, scipy and PIL calls,
so their JSON files and pickles are held byte for byte, their returned
values exactly, and their drawn images array for array.
"""
from __future__ import annotations

import json
import pickle

import numpy as np
import pytest
from PIL import Image

from sos_wsod_torch.data.catalog import DatasetCatalog
from sos_wsod_torch.data.datasets.voc import register_all_voc
from sos_wsod_torch.engine.synthetic import write_synthetic_voc
from sos_wsod_torch.tools import filter_metrics, pgt_to_json, proposals_convert, visualize
from sos_wsod_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from sos_wsod_tpu.data.datasets.voc import register_all_voc as jax_register_all_voc
from sos_wsod_tpu.tools import filter_metrics as jax_filter_metrics
from sos_wsod_tpu.tools import pgt_to_json as jax_pgt_to_json
from sos_wsod_tpu.tools import proposals_convert as jax_proposals_convert
from sos_wsod_tpu.tools import visualize as jax_visualize

CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair", "cow",
           "diningtable", "dog", "horse", "motorbike", "person", "pottedplant", "sheep", "sofa",
           "train", "tvmonitor")


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A synthetic VOC tree (cwd), its splits registered in both catalogs."""
    ids = write_synthetic_voc(str(tmp_path), (("train", 4), ("val", 2)), (60, 80), 5, seed=3)
    monkeypatch.chdir(tmp_path)
    register_all_voc()
    jax_register_all_voc()
    return tmp_path, ids


def test_pgt_to_json_main_byte_identical(tree):
    """Per-class detection text files (several lines an image, negatives,
    short lines) and positive lists -> byte-identical COCO JSONs."""
    root, ids = tree
    rng = np.random.default_rng(0)
    d = root / "pgt"
    d.mkdir()
    for c in CLASSES:
        lines = []
        for i in rng.choice(ids["train"], 6):
            x1, y1 = rng.uniform(0, 40, 2)
            lines.append(f"{i} {rng.random():.3f} {x1:.1f} {y1:.1f} {x1 + rng.uniform(1, 30):.1f} "
                         f"{y1 + rng.uniform(1, 20):.1f}")
        lines.append("short line")
        (d / f"det_{c}.txt").write_text("\n".join(lines) + "\n")
        (d / f"{c}_train.txt").write_text("".join(f"{i} {rng.choice(['1', '-1', '0'])}\n"
                                                  for i in ids["train"]))
    for name, mod in (("torch", pgt_to_json), ("jax", jax_pgt_to_json)):
        mod.main(["--det-tmpl", str(d / "det_{}.txt"), "--cls-tmpl", str(d / "{}_train.txt"),
                  "--image-dir", "datasets/VOC2007/JPEGImages",
                  "--split-txt", "datasets/VOC2007/ImageSets/Main/train.txt",
                  "--out", f"out/{name}.json"])
    got = (root / "out" / "torch.json").read_bytes()
    assert got == (root / "out" / "jax.json").read_bytes()
    assert json.loads(got)["annotations"]


def test_proposals_convert_byte_identical(tree, tmp_path_factory):
    """Selective search (one .mat of object arrays) and MCG (a .mat an
    image) through each main into byte-identical pickles; proposal_recall
    on them equal, at several top-k."""
    import scipy.io as sio

    root, ids = tree
    rng = np.random.default_rng(1)
    dicts = DatasetCatalog.get("voc_2007_train")
    raw = np.empty(len(dicts), object)
    mcg = root / "mcg"
    mcg.mkdir()
    for k, d in enumerate(dicts):
        y1, x1 = rng.uniform(1, 40, (2, 9))
        b = np.stack([y1, x1, y1 + rng.uniform(2, 20, 9), x1 + rng.uniform(2, 30, 9)], 1).round()
        raw[k] = b
        sio.savemat(mcg / f"{d['image_id']}.mat", {"boxes": b, "scores": rng.random((9, 1))})
    sio.savemat(root / "ss.mat", {"boxes": raw})
    for mode, src in (("ss", "ss.mat"), ("mcg", "mcg")):
        for name, mod in (("torch", proposals_convert), ("jax", jax_proposals_convert)):
            mod.main([mode, "voc_2007_train", src, f"{mode}_{name}.pkl"])
        got = (root / f"{mode}_torch.pkl").read_bytes()
        assert got == (root / f"{mode}_jax.pkl").read_bytes(), mode
        props = pickle.loads(got)
        for k in (1, 4, 4000):
            want = jax_proposals_convert.proposal_recall(
                JaxDatasetCatalog.get("voc_2007_train"), props, (0.1, 0.3, 0.5), k)
            assert proposals_convert.proposal_recall(dicts, props, (0.1, 0.3, 0.5), k) == want
        assert any(proposals_convert.proposal_recall(dicts, props, (0.1,)))
    flickr = [{"image_id": "7", "file_name": "x/000007.jpg"}]
    sio.savemat(mcg / "000007.mat", {"bboxes": raw[0], "bboxes_scores": rng.random((9, 1))})
    a = proposals_convert.convert_mcg_box("flickr_voc", flickr, str(mcg))
    b = jax_proposals_convert.convert_mcg_box("flickr_voc", flickr, str(mcg))
    assert pickle.dumps(a) == pickle.dumps(b)


@pytest.mark.parametrize("keys,every", [(None, 1), (["loss", "lr"], 1), (["total"], 3),
                                        (["nothing"], 1)])
def test_filter_metrics_main_byte_identical(tmp_path, keys, every):
    rng = np.random.default_rng(2)
    lines = [json.dumps({"iteration": i, "total_loss": float(rng.random()), "loss_cls": i * 0.5,
                         "lr": 0.02, "data_time": float(rng.random())}) for i in range(17)]
    (tmp_path / "metrics.json").write_text("\n".join(lines[:9]) + "\n\n" + "\n".join(lines[9:]))
    flags = ["--every", str(every)] + (["--keys", *keys] if keys else [])
    for name, mod in (("torch", filter_metrics), ("jax", jax_filter_metrics)):
        mod.main(["--input", str(tmp_path / "metrics.json"),
                  "--output", str(tmp_path / f"{name}.json"), *flags])
    got = (tmp_path / "torch.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert len(got.splitlines()) == (0 if keys == ["nothing"] else len(range(0, 17, every)))


def test_visualize_equal_arrays(tree):
    """A detection-result JSON (scores around the threshold, an image
    without a file, a limit) and a dataset with proposals: the same files,
    the same pixels."""
    root, ids = tree
    rng = np.random.default_rng(4)
    dets = [{"image_id": int(i), "category_id": int(rng.integers(1, 21)),
             "score": round(float(rng.random()), 3),
             "bbox": [round(float(v), 1)
                      for v in (*rng.uniform(0, 30, 2), *rng.uniform(35, 60, 2))]}
            for i in [*ids["train"], *ids["val"]] * 3]
    dets.append({"image_id": 99, "category_id": 1, "score": 0.9, "bbox": [1, 1, 5, 5]})
    (root / "dets.json").write_text(json.dumps(dets))
    img_dir = root / "named"
    img_dir.mkdir()
    for i in [*ids["train"], *ids["val"]]:
        Image.open(f"datasets/VOC2007/JPEGImages/{i}.jpg").save(img_dir / f"{int(i)}.jpg")
    counts = {}
    for name, mod in (("torch", visualize), ("jax", jax_visualize)):
        counts[name] = (
            mod.visualize_json_results("dets.json", str(img_dir), f"{name}_json", CLASSES, 0.3, 5),
            mod.visualize_dataset(
                [dict(d, proposal_boxes=np.asarray([[1, 2, 20, 30], [5, 5, 9, 9]]))
                 for d in DatasetCatalog.get("voc_2007_train")], f"{name}_data", CLASSES,
                limit=3, draw_proposals=1))
        mod.main(["--input", "dets.json", "--image-dir", str(img_dir), "--output",
                  f"{name}_main", "--conf-threshold", "0.6"])
    assert counts["torch"] == counts["jax"] and counts["torch"][0] == 5
    for sub in ("json", "data", "main"):
        files = sorted(p.name for p in (root / f"jax_{sub}").iterdir())
        assert files and files == sorted(p.name for p in (root / f"torch_{sub}").iterdir())
        for f in files:
            np.testing.assert_array_equal(np.asarray(Image.open(root / f"torch_{sub}" / f)),
                                          np.asarray(Image.open(root / f"jax_{sub}" / f)))
