"""The port's test-time augmentation (sos_wsod_torch/data/transforms.py
inverse_box, models/tta.py and the CLI tools/train_net_test_tta.py) against
the JAX package's (sos_wsod_tpu/models/tta.py, tools/train_net_test_tta.py),
on the CPU in float32, with the same numpy inputs and the same weights.

Each model runs 2 min sizes x flip = 4 views on a 60 x 80 image; both min
sizes give a 64 x 64 canvas, so each JAX program compiles once. The UNION
strategy over tests/test_torch_frcnn.py's R50-FPN is in
tests/test_torch_tta_union.py (its JAX compile alone takes most of a
minute, and --dist loadfile gives each file a worker).

Tolerances: the views, the inverse transforms and the host NMS are the
same numpy arithmetic, held exactly. The models: the stage-1
MultiInputRCNN (narrow DAN 16, the opts of tests/test_torch_imports.py)
within tests/test_torch_slice.py's bounds (scores 1e-4, boxes 1e-3
absolute), with the same kept detections.
The CLIs hold the rounded detections the VOC evaluator records and its AP
exactly equal, as tests/test_torch_unbias_cli.py does.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_torch.data import transforms as T
from sos_wsod_torch.engine.checkpoint import Checkpointer
from sos_wsod_torch.engine.synthetic import (
    load_config, random_d2_frcnn_state_dict, write_stage2_checkpoint, write_synthetic_voc)
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator
from sos_wsod_torch.models import tta
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN
from sos_wsod_torch.models.postprocess import fast_rcnn_inference_single
from sos_wsod_torch.tools import train_net_test_tta as cli
from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.data import transforms as JT
from sos_wsod_tpu.engine.defaults import default_argument_parser as jax_argument_parser
from sos_wsod_tpu.engine.weights import frcnn_param_tree
from sos_wsod_tpu.evaluation.voc_eval import PascalVOCDetectionEvaluator as JaxEvaluator
from sos_wsod_tpu.models import tta as jax_tta
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_tpu.models.postprocess import fast_rcnn_inference_single as jax_inference_single
from test_torch_unbias_cli import _capture

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAGE1 = str(ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml")
TTA = str(ROOT / "configs" / "stage23" / "voc07_tta_test.yaml")
STAGE1_OPTS = ["MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]", "TPU.COMPUTE_DTYPE", "float32",
               "TPU.PROPOSAL_CAPACITY", "32", "TEST.AUG.MIN_SIZES", "(40, 48)"]
FRCNN_OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "14",
              "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
              "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
              "TEST.AUG.MIN_SIZES", "(40, 48)"]
VIEWS = dict(min_sizes=(40, 48), max_size=4000, flip=True, size_divisibility=64)


def _image(seed, hw=(60, 80)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3)).astype(np.uint8)


def _proposals(rng, n, hw=(60, 80)):
    h, w = hw
    xy = rng.uniform(-5, (w - 8, h - 8), (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, (w / 2, h / 2), (n, 2))], 1)
    return boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32)


def test_inverse_box_round_trips_and_equals_jax():
    """Each transform's inverse_box (crop, resize, flip, their list, the
    no-op) undoes apply_box, equal to the JAX package's in value and dtype
    (float64; the no-op returns its input)."""
    rng = np.random.default_rng(0)
    boxes = np.abs(rng.standard_normal((6, 4))) * 50
    boxes[:, 2:] += boxes[:, :2] + 5
    rs = T.resize_shortest_edge(150, 250, [100], 400)
    jrs = JT.resize_shortest_edge(150, 250, [100], 400, None)
    pairs = [(T.CropTransform(10, 20, 150, 250), JT.CropTransform(10, 20, 150, 250, 200, 300)),
             (rs, jrs), (T.HFlipTransform(*rs.output_size), JT.HFlipTransform(*jrs.output_size)),
             (T.NoOpTransform(5, 7), JT.NoOpTransform(5, 7))]
    pairs.append((T.TransformList([p[0] for p in pairs]), JT.TransformList([p[1] for p in pairs])))
    for t, jt in pairs:
        fwd = t.apply_box(boxes.astype(np.float32))
        back = t.inverse_box(fwd)
        want = jt.inverse_box(fwd)
        assert back.dtype == want.dtype == (np.float32 if t is pairs[3][0] else np.float64)
        np.testing.assert_array_equal(back, want)
        np.testing.assert_allclose(back, boxes, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("flip,capacity", [(True, 32), (False, 8)])
def test_view_batches_equal_jax(flip, capacity):
    """The views' arrays (image, boxes clipped to the view, logits,
    validity, sizes) and the inverse maps, exactly."""
    rng = np.random.default_rng(1)
    boxes, logits = _proposals(rng, 20)
    image = _image(1)
    kw = dict(min_sizes=(40, 48, 100), max_size=90, flip=flip, capacity=capacity,
              size_divisibility=32)
    got = list(tta._view_batches(image, boxes, logits, **{**kw}))
    want = list(jax_tta._view_batches(image, boxes, logits, **kw))
    assert len(got) == len(want) == 3 * (1 + flip)
    view_boxes = rng.uniform(0, 40, (5, 4))
    for (b, inv), (jb, jinv) in zip(got, want):
        assert set(b) == set(jb)
        for k in b:
            assert b[k].dtype == jb[k].dtype and b[k].shape == jb[k].shape, k
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        np.testing.assert_array_equal(inv(view_boxes), jinv(view_boxes))


def test_batched_nms_np_equals_jax():
    rng = np.random.default_rng(2)
    boxes = np.round(rng.uniform(0, 50, (60, 4)), 0)
    boxes[:, 2:] += boxes[:, :2] + 1
    scores = np.round(rng.random(60), 1)   # ties
    classes = rng.integers(0, 3, 60)
    for thr in (0.3, 0.5, 0.7):
        keep = tta._batched_nms_np(boxes, scores, classes, thr)
        np.testing.assert_array_equal(keep, jax_tta._batched_nms_np(boxes, scores, classes, thr))
        assert 0 < len(keep) < 60
    assert tta._batched_nms_np(np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64), 0.5).size == 0


@pytest.fixture(scope="module")
def wsl_models():
    """The narrow stage-1 model of both packages with the JAX init's weights,
    the class scores spread as in tests/test_torch_slice.py."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(STAGE1)
    jcfg.merge_from_list(list(STAGE1_OPTS))
    jm = JaxMultiInputRCNN.from_cfg(jcfg)
    batch, _ = next(jax_tta._view_batches(_image(3), *_proposals(np.random.default_rng(3), 20),
                                          capacity=32, **VIEWS))
    params = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                             {k: jnp.asarray(v) for k, v in batch.items()}))
    params = {k: dict(v) for k, v in params["params"].items()}
    rng = np.random.RandomState(5)
    for k in range(4):
        branch = params["roi_heads"][f"box_refinery_{k}"]
        branch["cls_score"] = {"kernel": np.asarray(branch["cls_score"]["kernel"]) * 100,
                               "bias": np.asarray(branch["cls_score"]["bias"])}
    params["roi_heads"]["wsddn"] = {
        name: {"kernel": rng.randn(16, 20).astype(np.float32) * 0.01,
               "bias": np.zeros(20, np.float32)} for name in ("cls", "det")}
    cfg = load_config(STAGE1, STAGE1_OPTS)
    tm = load_weights(MultiInputRCNN.from_cfg(cfg, device="meta"), state_dict_from_flax(params),
                      "cpu")
    return jm, params, tm


def test_tta_avg_scores_matches_jax(wsl_models):
    """AVG over 4 views of the stage-1 model, then the one NMS: mean scores
    and boxes within the slice test's bounds, the same kept detections."""
    jm, params, tm = wsl_models
    image = _image(4)
    boxes, logits = _proposals(np.random.default_rng(4), 30)
    raw = jax.jit(lambda p, b: jm.apply({"params": p}, b)[1:])
    want = jax_tta.tta_avg_scores(
        lambda b: jax.device_get(raw(params, {k: jnp.asarray(v) for k, v in b.items()})),
        image, boxes, logits, capacity=32, **VIEWS)

    def predict_fn(b):
        with torch.inference_mode():
            return [t.numpy() for t in tm.predict_scores({k: torch.from_numpy(v)
                                                          for k, v in b.items()})]

    got = tta.tta_avg_scores(predict_fn, image, boxes, logits, capacity=32, **VIEWS)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[2], want[2])
    kw = dict(score_thresh=tm.score_thresh, nms_thresh=tm.nms_thresh, topk=16)
    jdet = jax_inference_single(jnp.asarray(want[1], jnp.float32),
                                jnp.asarray(want[0], jnp.float32), jnp.asarray(want[2]),
                                jnp.asarray([60.0, 80.0]), **kw)
    det = fast_rcnn_inference_single(torch.tensor(got[1], dtype=torch.float32),
                                     torch.tensor(got[0], dtype=torch.float32),
                                     torch.from_numpy(got[2]), torch.tensor([60.0, 80.0]), **kw)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(jdet.classes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=0, atol=1e-4)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), rtol=0, atol=1e-3)
    assert int(det.valid.sum()) > 0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_tta")
    write_synthetic_voc(str(root), (("test", 2),), (60, 80), 30, seed=0)
    return root


def _jax_main(monkeypatch, params, config, opts, strategy):
    from tools import train_net_test_tta as jax_cli

    monkeypatch.setattr(jax_cli, "_load_params", lambda cfg, args: params)
    parser = jax_argument_parser()
    parser.add_argument("--strategy", default="auto")
    parser.add_argument("--ckpt", default="")
    return jax_cli.main(parser.parse_args(["--config-file", config, "--strategy", strategy,
                                           *opts, "OUTPUT_DIR", "out_jax"]))


def _torch_main(config, opts, strategy):
    return cli.main(cli.argument_parser().parse_args(
        ["--config-file", config, "--strategy", strategy, *opts, "MODEL.DEVICE", "cpu",
         "OUTPUT_DIR", "out"]))


@pytest.mark.parametrize("strategy", ["auto", "union"])
def test_cli_main_matches_jax_stage1(tree, wsl_models, monkeypatch, strategy):
    """voc07_oicr_plus (AVG by default, and UNION) on the tree's 2 test
    images with their proposals: the same rounded detections and AP."""
    _, params, tm = wsl_models
    monkeypatch.chdir(tree)
    Checkpointer("out").save("model_final", {"model": tm.state_dict(), "iter": 3})
    jax_seen = _capture(monkeypatch, JaxEvaluator)
    want = _jax_main(monkeypatch, params, STAGE1, STAGE1_OPTS, strategy)
    seen = _capture(monkeypatch, PascalVOCDetectionEvaluator)
    got = _torch_main(STAGE1, STAGE1_OPTS, strategy)
    assert got == want and seen == jax_seen
    assert sum(len(v) for v in seen[0].values()) > 0


def test_cli_main_matches_jax_frcnn(tree, monkeypatch):
    """voc07_tta_test (UNION of the R50-FPN's detections) on the same
    weights: the same rounded detections and AP; a stage-1 single-view
    model is refused."""
    monkeypatch.chdir(tree)
    cfg = load_config(TTA, FRCNN_OPTS + ["MODEL.DEVICE", "cpu"])
    write_stage2_checkpoint("out", cfg, seed=0, iteration=5)
    params = frcnn_param_tree(random_d2_frcnn_state_dict(cfg, 0))
    jax_seen = _capture(monkeypatch, JaxEvaluator)
    want = _jax_main(monkeypatch, params, TTA, FRCNN_OPTS, "auto")
    seen = _capture(monkeypatch, PascalVOCDetectionEvaluator)
    got = _torch_main(TTA, FRCNN_OPTS, "auto")
    assert got == want and seen == jax_seen
    assert sum(len(v) for v in seen[0].values()) > 0
    with pytest.raises(NotImplementedError, match="GeneralizedRCNNWSL"):
        _torch_main(STAGE1, STAGE1_OPTS + ["MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL"], "avg")
