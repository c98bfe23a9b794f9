"""The pretrained-weight readers of sos_wsod_torch/engine/weights.py
against the JAX package's (sos_wsod_tpu/engine/weights.py), on synthetic
blobs made from a seed and pickled here:

  - ``load_pkl`` of a d2 ``.pkl`` (blobs under "model") and of a bare
    caffe2 one gives the JAX ``load_pkl``'s arrays;
  - ``state_dict_from_c2_resnet``, ``state_dict_from_d2_wsl`` and
    ``state_dict_from_torchvision_vgg16`` equal ``state_dict_from_flax`` of
    the JAX ``resnet_c2_param_tree`` (under backbone.bottom_up),
    ``vgg_wsl_param_tree`` and ``torchvision_vgg16_param_tree`` of the same
    blobs, key for key and bit for bit;
  - ``load_resnet_imagenet_weights``, ``load_vgg_wsl_weights`` and
    ``load_vgg_wsl_torch_checkpoint`` overwrite what they name and leave
    every other entry as initialised (a partial load too), and a blob of the
    wrong shape raises with its name and both shapes before anything is
    copied.
"""
from __future__ import annotations

import logging
import pathlib
import pickle
import re

import numpy as np
import pytest
import torch

from sos_wsod_tpu.engine import weights as jw
from sos_wsod_torch.engine import weights as tw
from sos_wsod_torch.engine.synthetic import (
    build_synthetic_frcnn, load_config, random_c2_resnet_blobs, random_d2_wsl_blobs)
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAGE2 = str(ROOT / "configs" / "stage23" / "voc_baseline.yaml")
R14 = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "14",
       "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.DEVICE", "cpu"]
def _pickle(path, obj) -> str:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def frcnn():
    return build_synthetic_frcnn(load_config(STAGE2, R14), "cpu", 0)


def test_c2_resnet_reader_equals_the_jax_tree_and_loads_bottom_up(frcnn, tmp_path):
    blobs = random_c2_resnet_blobs(frcnn.state_dict(), 1)
    path = _pickle(tmp_path / "R-14.pkl", blobs)
    loaded = tw.load_pkl(path)
    want_blobs = jw.load_pkl(path)
    assert sorted(loaded) == sorted(want_blobs)
    assert all(np.array_equal(loaded[k], want_blobs[k]) for k in want_blobs)
    got = tw.state_dict_from_c2_resnet(loaded)
    want = tw.state_dict_from_flax({"backbone": {"bottom_up": jw.resnet_c2_param_tree(loaded)}})
    _assert_same(got, want)
    assert torch.equal(got["backbone.bottom_up.stem.conv1_norm.running_var"],
                       torch.ones_like(got["backbone.bottom_up.stem.conv1_norm.weight"]))

    before = {k: v.clone() for k, v in frcnn.state_dict().items()}
    tw.load_resnet_imagenet_weights(frcnn, path)
    after = frcnn.state_dict()
    for k, v in after.items():
        if k in got:
            assert torch.equal(v, got[k]), k
        else:
            assert torch.equal(v, before[k]), k   # FPN, RPN, box head: as initialised
    assert any(k.startswith("backbone.fpn.") for k in after)


def test_d2_vgg_reader_equals_the_jax_tree_and_a_partial_load_keeps_the_rest(tmp_path,
                                                                            caplog):
    blobs = random_d2_wsl_blobs(3, 20, 4, (64, 64))
    blobs["roi_heads.box_predictor.extra.weight"] = np.ones((2, 2), np.float32)
    path = _pickle(tmp_path / "vgg_d2.pkl", {"model": blobs, "__author__": "synthetic"})
    loaded = tw.load_pkl(path)
    assert sorted(loaded) == sorted(jw.load_pkl(path)) == sorted(blobs)
    got = tw.state_dict_from_d2_wsl(loaded)
    _assert_same(got, tw.state_dict_from_flax(jw.vgg_wsl_param_tree(loaded)))

    model = MultiInputRCNN(num_classes=20, dan_dims=(64, 64), dan_dropout=0.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    part = {k: v for k, v in blobs.items() if not k.startswith("roi_heads.box_refinery_")}
    tw.load_vgg_wsl_weights(model, _pickle(tmp_path / "part.pkl", {"model": part}))
    for k, v in model.state_dict().items():
        want = got[k] if not k.startswith("roi_heads.box_refinery_") else before[k]
        assert torch.equal(v, want), k
    with caplog.at_level(logging.INFO, logger="sos_wsod_torch.engine.weights"):
        tw.load_vgg_wsl_weights(model, path)
        tw.load_pretrained(model, {"roi_heads.nowhere.weight": torch.zeros(2)})
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k]), k
    assert "unmatched checkpoint key: roi_heads.box_predictor.extra.weight" in caplog.text
    assert "no place for: roi_heads.nowhere.weight" in caplog.text

    # a released stage-1 .pth: the same blobs as tensors under "model"
    ckpt = tmp_path / "oicr_plus.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in blobs.items()}, "iteration": 7},
               ckpt)
    fresh = MultiInputRCNN(num_classes=20, dan_dims=(64, 64), dan_dropout=0.0)
    tw.load_vgg_wsl_torch_checkpoint(fresh, str(ckpt))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_torchvision_vgg16_reader_equals_the_jax_tree():
    g = torch.Generator().manual_seed(5)
    sd, cin = {}, 3
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                         (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g)
        sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g)
        cin = cout
    sd["classifier.0.weight"] = torch.randn(64, 512 * 49, generator=g)
    sd["classifier.0.bias"] = torch.randn(64, generator=g)
    sd["classifier.3.weight"] = torch.randn(64, 64, generator=g)
    sd["classifier.3.bias"] = torch.randn(64, generator=g)
    got = tw.state_dict_from_torchvision_vgg16(sd)
    want = tw.state_dict_from_flax(jw.torchvision_vgg16_param_tree(
        {k: v.numpy() for k, v in sd.items()}))
    _assert_same(got, want)
    model = MultiInputRCNN(num_classes=20, dan_dims=(64, 64))
    tw.load_pretrained(model, got)
    assert torch.equal(model.roi_heads.dan.fc2.weight, sd["classifier.3.weight"])


@pytest.mark.parametrize("reader", ["resnet", "vgg"])
def test_a_shape_mismatch_raises_with_the_name_and_both_shapes(frcnn, tmp_path, reader):
    if reader == "resnet":
        blobs = random_c2_resnet_blobs(frcnn.state_dict(), 2)
        blobs["res3_0_branch2b_w"] = blobs["res3_0_branch2b_w"][:, :-1]
        model, load = frcnn, tw.load_resnet_imagenet_weights
        name = "backbone.bottom_up.res3_block0.conv2.weight"
    else:
        blobs = random_d2_wsl_blobs(4, 20, 4, (64, 64))
        blobs["roi_heads.box_head.fc2.weight"] = blobs["roi_heads.box_head.fc2.weight"][:32]
        model = MultiInputRCNN(num_classes=20, dan_dims=(64, 64))
        load, name = tw.load_vgg_wsl_weights, "roi_heads.dan.fc2.weight"
    own = model.state_dict()[name]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = _pickle(tmp_path / "bad.pkl", {"model": blobs})
    match = (re.escape(f"shape mismatch at {name}: pretrained ") + r"\(.+\)" +
             re.escape(f" vs model {tuple(own.shape)}"))
    with pytest.raises(ValueError, match=match):
        load(model, path)
    # nothing was copied
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
