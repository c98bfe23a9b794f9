"""The port's stage-1 inference slice against the reference golden and the
JAX package: MultiInputRCNN.predict and run_stage1_inference on the CPU in
float32 (sos_wsod_torch/models/meta/rcnn_wsl.py, engine/defaults.py).

Tolerances: (a) uses the assertions of the JAX package's own composed-forward
golden test; (b) and (c) compare two f32 implementations whose convs and GEMMs
sum in different orders, so values agree to ~1e-6 relative and the stated
bounds leave two orders of magnitude; the JSON rounds scores to 3 decimals and
boxes to 1, so one rounding step is allowed there.
"""
from __future__ import annotations

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_golden_case import H, NUM_CLASSES, P, W, build_case
from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.engine.defaults import run_stage1_inference as jax_run_stage1_inference
from sos_wsod_tpu.evaluation.voc_eval import (
    PascalVOCDetectionEvaluator as JaxPascalVOCDetectionEvaluator,
)
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.data.voc import CLASS_NAMES
from sos_wsod_torch.engine.defaults import run_stage1_inference
from sos_wsod_torch.engine.weights import (
    load_weights,
    state_dict_from_d2_wsl,
    state_dict_from_flax,
)
from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN

ROOT = pathlib.Path(__file__).resolve().parents[1]
CANVAS = (64, 96)
DAN = (64, 64)


def test_forward_matches_reference_golden():
    """(a) goldens/oicr_plus_forward.npz, recorded from the reference's own
    torch graph on the weights of tests/model_golden_case.py."""
    z = np.load(ROOT / "tests" / "goldens" / "oicr_plus_forward.npz")
    image, rois, objectness, blobs = build_case()
    sd = state_dict_from_d2_wsl(blobs)
    # the golden case has no WSDDN layer; inference never reads it
    for name in ("cls", "det"):
        sd[f"roi_heads.wsddn.{name}.weight"] = torch.zeros(NUM_CLASSES, 4096)
        sd[f"roi_heads.wsddn.{name}.bias"] = torch.zeros(NUM_CLASSES)
    model = load_weights(MultiInputRCNN(num_classes=NUM_CLASSES, device="meta"), sd, "cpu")
    batch = {
        "image": torch.from_numpy(image),
        "valid_hw": torch.tensor([H, W]),
        "boxes": torch.from_numpy(np.ascontiguousarray(rois[:, 1:])),
        "objectness": torch.from_numpy(objectness),
        "prop_valid": torch.ones(P, dtype=torch.bool),
        "image_hw": torch.tensor([H, W]),
    }
    with torch.inference_mode():
        feat5 = model.backbone_features(batch["image"], batch["valid_hw"])
        _, scores, pred_boxes = model.predict(batch)
    assert feat5.is_contiguous()  # channels_last all the way: no copy for the kernel
    np.testing.assert_allclose(feat5.numpy(), z["feat5"].transpose(1, 2, 0),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), z["probs"], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(pred_boxes.numpy(), z["pred_boxes"], rtol=1e-4, atol=2e-2)


def _sample(rng, image_id, valid_hw, orig_hw, p=32, n_valid=28):
    h, w = valid_hw
    image = np.zeros(CANVAS + (3,), np.float32)
    image[:h, :w] = rng.uniform(0, 255, (h, w, 3))
    x1 = rng.uniform(0, w - 8, p)
    y1 = rng.uniform(0, h - 8, p)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(4, w / 2, p), w),
                      np.minimum(y1 + rng.uniform(4, h / 2, p), h)], 1)
    boxes[0] = [0, 0, w, h]
    boxes[n_valid:] = 0
    return {
        "image": image,
        "valid_hw": np.asarray(valid_hw, np.int32),
        "boxes": boxes.astype(np.float32),
        "objectness": rng.uniform(0, 1, p).astype(np.float32),
        "prop_valid": np.arange(p) < n_valid,
        "image_hw": np.asarray(valid_hw, np.float32),
        "image_id": image_id,
        "orig_hw": np.asarray(orig_hw, np.float32),
    }


@pytest.fixture(scope="module")
def models():
    """The JAX model with weights from its own init, and the port loaded with
    the same weights through state_dict_from_flax; each built from the config
    as its own package reads it."""
    config_file = str(ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(config_file)
    jm = JaxMultiInputRCNN.from_cfg(jcfg, dtype=jnp.float32, dan_dims=DAN)
    rng = np.random.RandomState(7)
    init_batch = {k: jnp.asarray(v) for k, v in _sample(rng, 0, (56, 80), (56, 80)).items()
                  if k not in ("image_id", "orig_hw")}
    params = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, init_batch))
    params = {k: dict(v) for k, v in params["params"].items()}
    for k in range(4):   # spread the class scores so ranks are not near-ties
        branch = params["roi_heads"][f"box_refinery_{k}"]
        branch["cls_score"] = {"kernel": np.asarray(branch["cls_score"]["kernel"]) * 100,
                               "bias": np.asarray(branch["cls_score"]["bias"])}
    # init through predict never builds the WSDDN layer; give it weights
    params["roi_heads"]["wsddn"] = {
        name: {"kernel": rng.randn(DAN[-1], NUM_CLASSES).astype(np.float32) * 0.01,
               "bias": np.zeros(NUM_CLASSES, np.float32)} for name in ("cls", "det")}
    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    tm = MultiInputRCNN.from_cfg(cfg, device="meta", dan_dims=DAN,
                                 compute_dtype=torch.float32)
    tm = load_weights(tm, state_dict_from_flax(params), "cpu")
    return jm, params, tm


def test_predict_matches_jax(models):
    """(b) MultiInputRCNN.predict on a padded canvas whose valid extent is
    smaller than the canvas, with padded proposal slots."""
    jm, params, tm = models
    sample = _sample(np.random.RandomState(11), 0, (50, 84), (50, 84))
    del sample["image_id"], sample["orig_hw"]
    jdet, jscores, jboxes = jax.jit(lambda p, b: jm.apply({"params": p}, b))(
        params, {k: jnp.asarray(v) for k, v in sample.items()})
    with torch.inference_mode():
        det, scores, boxes = tm.predict({k: torch.from_numpy(v) for k, v in sample.items()})
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0, atol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-3)
    assert int(det.valid.sum()) > 0
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(jdet.classes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=0, atol=1e-4)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), rtol=0, atol=1e-3)


def _annotations():
    return {str(i): {"boxes": np.asarray([[10.0, 12.0, 80.0, 90.0]]),
                     "classes": np.asarray([i % NUM_CLASSES]),
                     "difficult": np.zeros(1, bool)} for i in (1, 2)}


def test_run_stage1_inference_json_matches_jax(models, tmp_path):
    """(c) Two synthetic images through both run_stage1_inference runners,
    each into its own package's evaluator: the detection-result JSON (the
    stage-1 -> stage-2 contract) agrees."""
    jm, params, tm = models
    rng = np.random.RandomState(3)
    samples = [_sample(rng, 1, (56, 80), (112, 160)), _sample(rng, 2, (64, 90), (96, 135))]

    def evaluator(cls, tag):
        return cls("voc_2007_test", annotations=_annotations(), class_names=CLASS_NAMES,
                   save_detection_result=True, save_path=str(tmp_path / f"{tag}_{{}}.json"))

    jax_run_stage1_inference(jm, params, [dict(s) for s in samples],
                             evaluator(JaxPascalVOCDetectionEvaluator, "jax"))
    run_stage1_inference(tm, [dict(s) for s in samples],
                         evaluator(PascalVOCDetectionEvaluator, "torch"), "cpu")
    want = json.loads((tmp_path / "jax_voc_2007_test.json").read_text())
    got = json.loads((tmp_path / "torch_voc_2007_test.json").read_text())
    assert len(got) == len(want) > 0

    def key(d):
        return (d["image_id"], d["category_id"], -d["score"], d["bbox"])

    assert sorted((d["image_id"], d["category_id"]) for d in got) == \
        sorted((d["image_id"], d["category_id"]) for d in want)
    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= 1e-3 + 1e-9
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.1 + 1e-9)
