"""Parity of the port's box geometry, NMS and detection post-processing
(sos_wsod_torch/core/boxes.py, ops/nms.py, models/postprocess.py) with the JAX
package and the reference NMS golden.

Keep sets and classes must be equal. Float outputs agree within 1e-6: both
sides compute the same f32 expressions, and only the order of a few
operations may differ.
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.core import boxes as jbox
from sos_wsod_tpu.models.postprocess import (
    fast_rcnn_inference_single as jax_inference,
    rescale_detections as jax_rescale,
)
from sos_wsod_tpu.ops.nms import nms_mask as jax_nms_mask
from sos_wsod_torch.core import boxes as tbox
from sos_wsod_torch.models.postprocess import fast_rcnn_inference_single, rescale_detections
from sos_wsod_torch.ops.nms import nms_mask

GOLD = pathlib.Path(__file__).parent / "goldens"


def _rand_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(0, size / 2, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[0] = [10, 10, 10, 30]          # zero-area box
    b[1] = b[2]                      # duplicate
    return b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("thr", [0.01, 0.3, 0.7])
def test_nms_mask_matches_jax(thr):
    """Batched (K, S) problems give the keep sets of JAX nms_mask run per
    problem, including tied scores and invalid slots."""
    rng = np.random.RandomState(int(thr * 100))
    k, s = 5, 64
    boxes = np.stack([_rand_boxes(rng, s) for _ in range(k)])
    scores = np.round(rng.rand(k, s), 1).astype(np.float32)   # many ties
    valid = rng.rand(k, s) > 0.15
    got = nms_mask(_t(boxes), _t(scores), _t(valid), thr).numpy()
    for i in range(k):
        want = np.asarray(jax_nms_mask(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                       jnp.asarray(valid[i]), thr))
        np.testing.assert_array_equal(got[i], want)


def test_nms_mask_matches_reference_golden():
    """Keep sets of the reference's compiled greedy loop (goldens/nms.npz),
    with unique scores and with the golden's tie-resolved order injected as
    surrogate scores (as tests/test_reference_goldens.py does)."""
    z = np.load(GOLD / "nms.npz")
    d = z["dets0"]
    xyxy = np.stack([d[:, 0] - d[:, 2] / 2, d[:, 1] - d[:, 3] / 2,
                     d[:, 0] + d[:, 2] / 2, d[:, 1] + d[:, 3] / 2], 1)
    valid = torch.ones(len(d), dtype=torch.bool)
    for thr in (0.3, 0.5, 0.7):
        keep = nms_mask(_t(xyxy), _t(z["scores"]), valid, thr)
        assert set(torch.nonzero(keep)[:, 0].tolist()) == set(z["keep0_%d" % int(thr * 100)].tolist())
    order = z["order_tied"]
    surrogate = np.empty(len(order), np.float32)
    surrogate[order] = np.arange(len(order), 0, -1, dtype=np.float32)
    for thr in (0.01, 0.3, 0.5):
        keep = nms_mask(_t(xyxy), _t(surrogate), valid, thr)
        assert set(torch.nonzero(keep)[:, 0].tolist()) == set(z["keep_tied_%d" % int(thr * 100)].tolist())


def test_pairwise_iou_and_apply_deltas_match_jax():
    rng = np.random.RandomState(1)
    a = _rand_boxes(rng, 30)
    b = _rand_boxes(rng, 20)
    np.testing.assert_allclose(tbox.pairwise_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    deltas = rng.randn(30, 20 * 4).astype(np.float32)
    deltas[:5, 2::4] = 40.0                      # dw past SCALE_CLAMP
    deltas[5:10, 3::4] = 50.0                    # dh past SCALE_CLAMP
    got = tbox.apply_deltas(_t(deltas), _t(a)).numpy()
    want = np.asarray(jbox.apply_deltas(jnp.asarray(deltas), jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fast_rcnn_inference_single_matches_jax():
    """Same (pred_boxes, scores) in, same detections out: classes and valid
    flags equal, boxes and scores within 1e-6, with tied scores and a top-k
    that cuts through them."""
    rng = np.random.RandomState(4)
    p, k = 48, 6
    prop = _rand_boxes(rng, p, 80.0)
    pred = np.tile(prop, (1, k)) + rng.randn(p, 4 * k).astype(np.float32) * 3
    probs = rng.dirichlet(np.ones(k + 1), p)
    probs = np.round(probs, 2).astype(np.float32)              # ties
    probs[3, 0] = np.nan                                       # non-finite row
    valid = np.ones(p, bool)
    valid[-4:] = False
    hw = np.asarray([70.0, 90.0], np.float32)
    kw = dict(score_thresh=0.05, nms_thresh=0.3, topk=40)
    want = jax_inference(jnp.asarray(pred), jnp.asarray(probs), jnp.asarray(valid),
                         jnp.asarray(hw), **kw)
    got = fast_rcnn_inference_single(_t(pred), _t(probs), _t(valid), _t(hw), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-6)

    orig = np.asarray([140.0, 200.0], np.float32)
    want_r = jax_rescale(want, jnp.asarray(hw), jnp.asarray(orig))
    got_r = rescale_detections(got, _t(hw), _t(orig))
    np.testing.assert_allclose(got_r.boxes.numpy(), np.asarray(want_r.boxes), rtol=0, atol=1e-5)
