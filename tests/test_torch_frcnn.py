"""The port's stage-2/3 detector (sos_wsod_torch/models: anchors, ResNet-FPN,
RPN inference, StandardROIHeads.predict, GeneralizedRCNN) against the JAX
package's, on the CPU in f32, with the same numpy inputs and the JAX model's
weights carried across by engine/weights.py:state_dict_from_flax.

The JAX reference is initialised with branch="inference" (which creates every
parameter predict uses) and jitted once, in one module-scoped fixture, at
the small config of tests/test_faster_rcnn.py:52-78 (R50-FPN, pre/post-NMS
top-k 64/32, fc 64, 16 detections) on a 64x64 image; its FrozenBN
statistics and conv biases are drawn at random so that they matter, and the
class scores are spread so that detections pass the 0.05 threshold.

Tolerances: anchors and find_top_rpn_proposals on the same logits and boxes
are exact, tie order included (the selection is the same f32 compares and a
stable descending sort on both sides). Everything downstream of a
convolution is held within 1e-4 relative (ResNet-50's 53 convolutions sum
in another order in XLA and in torch): features, proposals, class
probabilities and boxes, with equal validity masks and classes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.anchors import AnchorGenerator as JaxAnchorGenerator
from sos_wsod_tpu.models.anchors import cell_anchors as jax_cell_anchors
from sos_wsod_tpu.models.anchors import grid_anchors as jax_grid_anchors
from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from sos_wsod_tpu.models.proposal_generator.rpn import (
    find_top_rpn_proposals as jax_find_top_rpn_proposals,
)
from sos_wsod_tpu.models.roi_heads.standard import StandardROIHeads as JaxStandardROIHeads
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.anchors import AnchorGenerator, cell_anchors, grid_anchors
from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN, TwoStagePseudoLabGeneralizedRCNN
from sos_wsod_torch.models.proposal_generator.rpn import RPN, find_top_rpn_proposals
from sos_wsod_torch.models.roi_heads.standard import StandardROIHeads

RTOL, ATOL = 1e-4, 1e-4
HW = 64


def test_anchors_match_jax_exactly():
    for sizes, ratios in (([32], [0.5, 1.0, 2.0]), ([64, 128], [0.25, 1.0]), ([512], [1.0])):
        np.testing.assert_array_equal(cell_anchors(sizes, ratios), jax_cell_anchors(sizes, ratios))
    base = cell_anchors([32], [0.5, 1.0, 2.0])
    for offset in (0.0, 0.5):
        np.testing.assert_array_equal(grid_anchors((5, 7), 8, base, offset),
                                      jax_grid_anchors((5, 7), 8, base, offset))
    kw = dict(sizes=[[32], [64], [128], [256], [512]], aspect_ratios=[[0.5, 1.0, 2.0]],
              strides=[4, 8, 16, 32, 64])
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    for a, b in zip(AnchorGenerator(**kw)(shapes), JaxAnchorGenerator(**kw)(shapes)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert AnchorGenerator(**kw).num_anchors_per_location == [3] * 5


@pytest.mark.parametrize("pre,post,min_size", [(30, 20, 0.0), (100, 50, 2.0), (8, 30, 0.0)])
def test_find_top_rpn_proposals_matches_jax_exactly(pre, post, min_size):
    """Tied logits (quantized), boxes partly outside the image, empty and
    NaN-scored candidates: the same selection, in the same order."""
    rng = np.random.default_rng(pre)
    sizes = (120, 60, 30, 12, 5)
    logits = [np.round(rng.standard_normal(n), 1).astype(np.float32) for n in sizes]
    logits[1][3] = np.nan
    boxes = []
    for n in sizes:
        xy = rng.uniform(-20, 70, (n, 2))
        wh = rng.uniform(0, 40, (n, 2))
        boxes.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
    hw = np.array([60.0, 64.0], np.float32)
    got = find_top_rpn_proposals([torch.from_numpy(x) for x in logits],
                                 [torch.from_numpy(x) for x in boxes], torch.from_numpy(hw),
                                 pre_nms_topk=pre, post_nms_topk=post, nms_thresh=0.7,
                                 min_size=min_size)
    want = jax_find_top_rpn_proposals([jnp.asarray(x) for x in logits],
                                      [jnp.asarray(x) for x in boxes], jnp.asarray(hw),
                                      pre_nms_topk=pre, post_nms_topk=post, nms_thresh=0.7,
                                      min_size=min_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[2].sum()) <= post


def _randomize(params, rng):
    """FrozenBN statistics and conv/dense biases drawn at random; the stem
    scaled to the pixel range and each residual branch's last FrozenBN to
    about 0.3, so that the features stay near unit size through the 16
    blocks; class scores spread x30 so that probabilities pass 0.05."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if path[-1].endswith("_norm"):
                gain = 0.3 if path[-1] == "conv3_norm" and k == "weight" else 1.0
                a = (rng.uniform(0.5, 1.5, a.shape) * gain if k in ("weight", "running_var")
                     else rng.normal(0, 0.1, a.shape)).astype(np.float32)
            elif path[-2:] == ("stem", "conv1"):
                a = a / 64
            elif k == "bias":
                a = rng.normal(0, 0.05, a.shape).astype(np.float32)
            elif path[-1] == "cls_score" and k == "kernel":
                a = a * 30
            out[k] = a
        return out
    return walk(params, ())


def _image(rng, fill=None):
    img = rng.uniform(0, 255, (HW, HW, 3)).astype(np.float32)
    if fill is not None:
        img[:] = fill
    return img


@pytest.fixture(scope="module")
def models():
    """The JAX model at the small config, its params, its jitted predict on
    one image, and the port's model with the same weights."""
    jm = JaxGeneralizedRCNN(
        num_classes=20,
        rpn_kw=dict(pre_nms_topk_train=64, post_nms_topk_train=32, pre_nms_topk_test=64,
                    post_nms_topk_test=32),
        roi_kw=dict(batch_size_per_image=32, fc_dim=64, detections_per_image=16))
    rng = np.random.default_rng(0)
    batch = {"image": jnp.asarray(_image(rng)), "image_hw": jnp.asarray([60.0, 64.0])}
    init = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, branch="inference"))
    params = _randomize(jax.device_get(init(batch))["params"], rng)
    predict = jax.jit(lambda p, b: jm.apply({"params": p}, b, branch="inference"))
    pm = GeneralizedRCNN(RPN(pre_nms_topk_test=64, post_nms_topk_test=32, device="meta"),
                         StandardROIHeads(fc_dim=64, detections_per_image=16, device="meta"),
                         device="meta")
    pm = load_weights(pm, state_dict_from_flax(params), "cpu")
    return jm, params, predict, pm, {k: np.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def test_resnet_fpn_features_match_jax(models):
    jm, params, _, pm, batch = models
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=JaxGeneralizedRCNN._features))(
        params, batch["image"])
    with torch.inference_mode():
        got = pm._features(_t(batch)["image"])
    assert sorted(got) == ["p2", "p3", "p4", "p5", "p6"]
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.shape[0] == 1 and tuple(v.shape[2:]) == w.shape[:2] and v.shape[1] == w.shape[2]
        scale = np.abs(w).max()
        np.testing.assert_allclose(v[0].permute(1, 2, 0).numpy(), w, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)


def test_roi_heads_predict_matches_jax(models):
    """The same features and proposals into StandardROIHeads.predict, with
    the e2e model's head weights. The pooler samples 2 x 2 a bin here, which
    keeps XLA's compile short; the adaptive grid is held against JAX in
    tests/test_torch_roi_align.py and end to end below."""
    _, params, _, _, _ = models
    rng = np.random.default_rng(1)
    feats = {f"p{i}": rng.standard_normal((HW // 2 ** i + 1, HW // 2 ** i + 2, 256))
             .astype(np.float32) for i in (2, 3, 4, 5)}
    xy = rng.uniform(0, 50, (32, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (32, 2))], 1).astype(np.float32)
    valid = rng.uniform(0, 1, 32) > 0.2
    hw = np.array([60.0, 64.0], np.float32)
    kw = dict(fc_dim=64, detections_per_image=16, pooler_sampling_ratio=2)
    jh = JaxStandardROIHeads(**kw)
    jdet, jprobs, jboxes = jax.jit(lambda p, *a: jh.apply({"params": p}, *a, method="predict"))(
        params["roi_heads"], feats, boxes, valid, hw)
    ph = load_weights(StandardROIHeads(**kw, device="meta"),
                      state_dict_from_flax(params["roi_heads"]), "cpu")
    with torch.inference_mode():
        det, probs, pred_boxes = ph.predict(
            {k: torch.from_numpy(v) for k, v in feats.items()}, torch.from_numpy(boxes),
            torch.from_numpy(valid), torch.from_numpy(hw))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pred_boxes.numpy(), np.asarray(jboxes), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(jdet.classes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), rtol=RTOL, atol=ATOL)
    assert int(det.valid.sum()) > 0


def test_generalized_rcnn_predict_matches_jax(models):
    """End to end: backbone, RPN (anchors, decode, top-k, batched NMS),
    multi-level ROIAlign, box head and post-processing."""
    _, params, predict, pm, batch = models
    jdet, (jpb, jpl, jpv), (jprobs, jboxes) = predict(params, batch)
    with torch.inference_mode():
        det, (pb, pl, pv), (probs, pred_boxes) = pm(_t(batch), branch="inference")
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jpb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jpl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pred_boxes.numpy(), np.asarray(jboxes), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.classes.numpy(), np.asarray(jdet.classes))
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(det.boxes.numpy(), np.asarray(jdet.boxes), rtol=RTOL, atol=ATOL)
    assert det.boxes.shape == (16, 4) and pb.shape == (32, 4) and probs.shape == (32, 21)
    assert int(det.valid.sum()) > 0 and int(pv.sum()) > 0
    with torch.inference_mode():
        weak = pm(_t(batch), branch="unsup_data_weak")
    assert torch.equal(weak[0].boxes, det.boxes)


@pytest.mark.parametrize("fill", [np.inf, np.nan])
def test_inf_nan_image_yields_no_detections(models, fill):
    """tests/test_faster_rcnn.py:142-154: an all-inf or all-NaN image comes
    back with zero valid detections."""
    _, _, _, pm, batch = models
    bad = dict(batch, image=_image(np.random.default_rng(0), fill))
    with torch.inference_mode():
        det, _, _ = pm.predict(_t(bad))
    assert int(det.valid.sum()) == 0


def test_training_branches_raise_and_alias(models):
    """"supervised" and "val_loss" run the losses on a batch (the latter
    without the gt appended to the proposals); their parity with the JAX
    losses is tests/test_torch_frcnn_train.py's. An unknown branch raises."""
    pm, batch = models[3], models[4]
    rng = np.random.default_rng(3)
    gt = np.zeros((1, 4, 4), np.float32)
    gt[0, :2] = [[4, 6, 30, 40], [20, 10, 60, 50]]
    train = {"image": torch.from_numpy(batch["image"][None].copy()),
             "image_hw": torch.tensor([[60.0, 64.0]]), "gt_boxes": torch.from_numpy(gt),
             "gt_classes": torch.from_numpy(rng.integers(0, 20, (1, 4)).astype(np.int32)),
             "gt_valid": torch.tensor([[True, True, False, False]])}
    keys = {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
    with torch.no_grad():
        for branch in ("supervised", "val_loss"):
            losses = pm(train, branch=branch, generator=torch.Generator().manual_seed(0))
            assert set(losses) == keys and all(torch.isfinite(v) for v in losses.values())
    with pytest.raises(ValueError, match="Unknown branch"):
        pm({}, branch="teacher")
    assert TwoStagePseudoLabGeneralizedRCNN is GeneralizedRCNN
