"""The port's stage-2/3 data path (sos_wsod_torch/data/strong_augmentation.py,
data/mapper_twocrop.py) against the JAX package's, exactly: the same seed
gives the same arrays (numpy and PIL on both sides, the same draws in the
same order); and the synthetic tree's pseudo labels and dataseed
(engine/synthetic.py) read by both packages' loaders.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from sos_wsod_tpu.data.datasets.voc import load_voc_instances_wsl as jax_load_wsl
from sos_wsod_tpu.data.mapper_twocrop import (
    DatasetMapperTwoCropSeparate as JaxMapper,
    build_semisup_two_crop_loader as jax_loader,
    divide_label_unlabel as jax_divide,
)
from sos_wsod_tpu.data.strong_augmentation import build_strong_augmentation as jax_strong
from sos_wsod_torch.data.datasets.voc import load_voc_instances_wsl
from sos_wsod_torch.data.mapper_twocrop import (
    DatasetMapperTwoCropSeparate,
    build_semisup_two_crop_loader,
    divide_label_unlabel,
)
from sos_wsod_torch.data.strong_augmentation import build_strong_augmentation
from sos_wsod_torch.engine.synthetic import (
    load_config,
    write_dataseed,
    write_pseudo_labels,
    write_synthetic_voc,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = str(ROOT / "configs" / "stage23" / "voc_baseline.yaml")


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_strong_augmentation_matches_jax(seed):
    img = np.random.RandomState(seed).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    ours, theirs = build_strong_augmentation(seed), jax_strong(seed)
    for _ in range(3):
        np.testing.assert_array_equal(ours(img), theirs(img))


def _dicts(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(40, 80, 2)
        anns = [{"category_id": int(rng.randint(20)),
                 "bbox": [float(x) for x in (rng.uniform(0, w / 2), rng.uniform(0, h / 2),
                                             rng.uniform(w / 2, w), rng.uniform(h / 2, h))]}
                for _ in range(rng.randint(1, 4))]
        anns.append({"category_id": 3, "bbox": [0.0, 0.0, 5.0, 5.0], "iscrowd": 1})
        d = {"image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8), "image_id": f"{i:06d}",
             "annotations": anns}
        if i % 2:
            d["multi_label"] = [1, 7]
        out.append(d)
    return out


@pytest.mark.parametrize("crop", [False, True])
def test_two_crop_mapper_matches_jax(crop):
    """Strong and weak views, gt at capacity 4 (an image may hold more),
    crowd regions dropped, multi-label one-hot from the file or the gt."""
    kw = dict(min_size_train=[32, 48, 64], max_size_train=100, crop_enabled=crop, gt_capacity=4,
              num_classes=20, size_divisibility=32, seed=11)
    ours, theirs = DatasetMapperTwoCropSeparate(**kw), JaxMapper(**kw)
    for d in _dicts(6):
        for a, b in zip(ours(d), theirs(d)):
            _assert_same(a, b)


def test_two_crop_loader_matches_jax():
    """Three batches of the two-crop loader: the same images in the same
    order, on the same canvases, q and k of a stream on one canvas."""
    kw = dict(min_size_train=[32, 48, 64], max_size_train=100, gt_capacity=4, num_classes=20,
              size_divisibility=32, seed=5)
    lab, unlab = _dicts(5, 1), _dicts(4, 2)
    ours = build_semisup_two_crop_loader(lab, unlab, DatasetMapperTwoCropSeparate(**kw), 2, 2,
                                         seed=3, size_divisibility=32)
    theirs = jax_loader(lab, unlab, JaxMapper(**kw), 2, 2, seed=3, size_divisibility=32)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"label_q", "label_k", "unlabel_q", "unlabel_k"}
        for k in a:
            assert len(a[k]) == len(b[k]) == 2
            for x, y in zip(a[k], b[k]):
                _assert_same(x, y)
        assert a["label_q"][0]["image"].shape == a["label_k"][1]["image"].shape


def test_divide_label_unlabel_matches_jax(tmp_path):
    dicts = [{"image_id": i} for i in range(10)]
    seedfile = tmp_path / "seed.json"
    seedfile.write_text(json.dumps({"20.0": {"1": [2, 5]}}))
    got = divide_label_unlabel(dicts, 20.0, 1, str(seedfile))
    assert got == jax_divide(dicts, 20.0, 1, str(seedfile))
    assert [d["image_id"] for d in got[0]] == [2, 5] and len(got[1]) == 8
    short = tmp_path / "short.json"
    short.write_text(json.dumps({"20.0": {"1": [2]}}))
    with pytest.raises(ValueError, match="labeled indices"):
        divide_label_unlabel(dicts, 20.0, 1, str(short))


def test_synthetic_tree_feeds_both_loaders(tmp_path):
    """engine/synthetic.py's pseudo-label JSON reads the same in both
    packages' VOC loaders (the objects not marked difficult, multi-label);
    its dataseed divides voc_baseline's train + val as the config asks."""
    ids = write_synthetic_voc(str(tmp_path), (("train", 3), ("val", 2)), (40, 60), 5, seed=1)
    write_pseudo_labels(str(tmp_path))
    voc = str(tmp_path / "datasets" / "VOC2007")
    for split in ("train", "val"):
        ours, theirs = load_voc_instances_wsl(voc, split), jax_load_wsl(voc, split)
        assert ours == theirs and [d["image_id"] for d in ours] == ids[split]
        assert all(d["annotations"] and d["multi_label"] for d in ours)
    cfg = load_config(BASELINE)
    path = write_dataseed(str(tmp_path), cfg, 5)
    assert path.endswith("VOC_all.txt")
    dicts = load_voc_instances_wsl(voc, "train") + load_voc_instances_wsl(voc, "val")
    lab, unlab = divide_label_unlabel(dicts, cfg.DATALOADER.SUP_PERCENT,
                                      cfg.DATALOADER.RANDOM_DATA_SEED, path)
    assert len(lab) == int(0.99981 * 5) == 4 and len(unlab) == 1
