"""The port's host-side modules against the JAX package's: the YAML config
read (sos_wsod_torch/config.py), the test-time resize and box clip
(data/transforms.py), the VOC class names (data/voc.py), the VOC evaluator
and its detection-result JSON (evaluation/voc_eval.py) and the d2-WSL weight
mapping (engine/weights.py). All of it is numpy or PIL on both sides and
computes the same operations in the same order, so every comparison is exact.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from sos_wsod_torch import config as tcfg
from sos_wsod_torch.data import transforms as tT
from sos_wsod_torch.data.voc import CLASS_NAMES
from sos_wsod_torch.engine.synthetic import random_d2_wsl_blobs
from sos_wsod_torch.engine.weights import state_dict_from_d2_wsl, state_dict_from_flax
from sos_wsod_torch.evaluation import voc_eval as tvoc
from sos_wsod_tpu import config as jcfg
from sos_wsod_tpu.data import transforms as jT
from sos_wsod_tpu.data.datasets.voc import CLASS_NAMES as JAX_CLASS_NAMES
from sos_wsod_tpu.engine.weights import vgg_wsl_param_tree
from sos_wsod_tpu.evaluation import voc_eval as jvoc

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAGE1_CONFIGS = ["stage1/voc07_oicr_plus.yaml", "quick_schedules/oicr_plus_instant_test.yaml",
                  "quick_schedules/oicr_plus_inference_acc_test.yaml"]
STAGE23_CONFIGS = ["stage23/voc_baseline.yaml", "stage23/voc_ssod.yaml"]


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _get(node, dotted):
    for p in dotted.split("."):
        node = node[p]
    return node


def _assert_same_leaves(port, ref):
    """Keys the port's defaults name: the same value and type. Keys that come
    only from a YAML file: the same value (the JAX defaults hold some of them
    as tuples, the YAML as lists). MODEL.DEVICE is the one key whose value
    differs by design: the port's CLI reads it as a torch device ("cuda", as
    in detectron2), where nothing in the JAX package reads its "tpu"."""
    defaults = dict(_leaves(tcfg.get_cfg()))
    assert (port.MODEL.DEVICE, ref.MODEL.DEVICE) == ("cuda", "tpu")
    for key, value in _leaves(port):
        if key == "MODEL.DEVICE":
            continue
        want = _get(ref, key)
        if key not in defaults and isinstance(want, tuple):
            want = list(want)
        assert type(value) is type(want) and value == want, (key, value, want)


@pytest.mark.parametrize("name", [None] + STAGE1_CONFIGS + STAGE23_CONFIGS)
def test_config_matches_jax(name):
    """Every key of the port's tree, defaults alone or after merging a
    stage-1 or stage-2/3 YAML chain, has the JAX package's value."""
    port, ref = tcfg.get_cfg(), jcfg.get_cfg()
    if name:
        port.merge_from_file(str(ROOT / "configs" / name))
        ref.merge_from_file(str(ROOT / "configs" / name))
    _assert_same_leaves(port, ref)
    if name in STAGE1_CONFIGS:   # keys the defaults do not name come through
        assert port.MODEL.ROI_HEADS.IOU_THRESHOLDS == [0.5, 0.6]
        assert port.OICRPLUS.PROPOSAL_NUM == 1000000
    if name in STAGE23_CONFIGS:
        assert port.MODEL.RPN.IN_FEATURES == ["p2", "p3", "p4", "p5", "p6"]
        assert port.MODEL.ANCHOR_GENERATOR.SIZES == [[32], [64], [128], [256], [512]]
        assert (port.INPUT.MIN_SIZE_TEST, port.TEST.DETECTIONS_PER_IMAGE) == (688, 100)
        assert port.SEMISUPNET.EVAL_TEACHER is ("ssod" in name)
        assert port.DATALOADER.RANDOM_DATA_SEED_PATH.startswith("./dataseed/")


def test_config_overrides_coerce_like_jax():
    opts = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "1", "TEST.DETECTIONS_PER_IMAGE", "50",
            "WSL.REFINE_REG", "[True, False, True]", "MODEL.PIXEL_MEAN", "(1.0, 2.0, 3.0)",
            "TPU.COMPUTE_DTYPE", "float32"]
    port, ref = tcfg.get_cfg(), jcfg.get_cfg()
    port.merge_from_list(opts)
    ref.merge_from_list(opts)
    _assert_same_leaves(port, ref)
    with pytest.raises(ValueError, match="type mismatch"):
        port.merge_from_list(["WSL.REFINE_NUM", "'four'"])
    with pytest.raises(KeyError):
        port.merge_from_list(["TEST.NO_SUCH_KEY", "1"])


@pytest.mark.parametrize("hw,size,max_size", [((375, 500), 688, 4000), ((500, 375), 688, 4000),
                                              ((333, 500), 688, 900), ((480, 480), 600, 1000),
                                              ((200, 1500), 688, 1333)])
def test_resize_and_clip_match_jax(hw, size, max_size):
    rng = np.random.RandomState(sum(hw) + size)
    h, w = hw
    port = tT.resize_shortest_edge(h, w, size, max_size)
    ref = jT.resize_shortest_edge(h, w, [size], max_size)
    assert port.output_size == ref.output_size
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    np.testing.assert_array_equal(port.apply_image(image), ref.apply_image(image))
    with pytest.raises(ValueError, match="uint8"):
        port.apply_image(image.astype(np.float32))
    boxes = rng.uniform(-20, 1.2 * max(hw), (50, 4)).astype(np.float32)
    np.testing.assert_array_equal(port.apply_box(boxes), ref.apply_box(boxes))
    out_hw = port.output_size
    np.testing.assert_array_equal(tT.clip_boxes(port.apply_box(boxes), out_hw),
                                  jT.clip_boxes_np(ref.apply_box(boxes), out_hw))


def _eval_case(seed):
    """Ground truth with difficult objects, images without a class, and
    detections with tied scores, duplicates and misses."""
    rng = np.random.RandomState(seed)
    annotations, dets = {}, []
    for i in range(12):
        n = rng.randint(0, 4)
        xy = rng.uniform(0, 300, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 200, (n, 2))], 1).round()
        annotations[str(100 + i)] = {"boxes": boxes, "classes": rng.randint(0, 5, n),
                                     "difficult": rng.rand(n) < 0.2}
        m = rng.randint(0, 30)
        jitter = rng.normal(0, 15, (m, 4))
        base = boxes[rng.randint(0, n, m)] if n else rng.uniform(0, 300, (m, 4))
        det_boxes = np.sort((base + jitter).reshape(m, 2, 2), axis=1).reshape(m, 4) - 1
        scores = rng.choice([0.9, 0.5, 0.25, 0.125], m) if i % 3 == 0 else rng.rand(m)
        dets.append((100 + i, det_boxes, scores, rng.randint(0, 5, m), rng.rand(m) < 0.9))
    return annotations, dets


@pytest.mark.parametrize("year", [2007, 2012])
def test_voc_evaluator_matches_jax(year, tmp_path):
    """Same detections into both evaluators: the same results, bit for bit,
    and the same detection-result JSON."""
    assert CLASS_NAMES == JAX_CLASS_NAMES
    annotations, dets = _eval_case(year)
    names = CLASS_NAMES[:5]
    port = tvoc.PascalVOCDetectionEvaluator("voc_test", annotations, names, year=year,
                                            save_detection_result=True,
                                            save_path=str(tmp_path / "port_{}.json"))
    ref = jvoc.PascalVOCDetectionEvaluator("voc_test", annotations=annotations,
                                           class_names=names, year=year,
                                           save_detection_result=True,
                                           save_path=str(tmp_path / "jax_{}.json"))
    for ev in (port, ref):
        for d in dets:
            ev.process_single(*d)
    got, want = port.evaluate(), ref.evaluate()
    assert got == want and 0 < got["bbox"]["AP50"] < 100
    assert json.loads((tmp_path / "port_voc_test.json").read_text()) == \
        json.loads((tmp_path / "jax_voc_test.json").read_text())


def test_d2_wsl_state_dict_matches_jax_mapping():
    """The direct d2-WSL -> state dict mapping equals the JAX package's name
    mapping followed by the flax bridge, for prefixed and bare backbone keys;
    keys it does not know are skipped by both."""
    blobs = random_d2_wsl_blobs(3, 20, 4, (16, 8))
    blobs["plain1.conv1.bias"] = blobs.pop("backbone.plain1.conv1.bias")
    blobs["roi_heads.box_predictor.bbox_pred.weight"] = np.zeros((4, 8), np.float32)
    got = state_dict_from_d2_wsl(blobs)
    want = state_dict_from_flax(vgg_wsl_param_tree(dict(blobs)))
    assert sorted(got) == sorted(want) and len(got) == 26 + 4 + 4 + 16
    for k in want:
        assert torch.equal(got[k], want[k]), k
