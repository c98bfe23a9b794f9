"""The port's box encoding, matcher and stage-1 losses against the JAX
package's: get_deltas (core/boxes.py), Matcher (core/matcher.py),
wsddn_scores / mil_loss (models/heads/wsddn.py), weighted_ce_loss and
box_reg_loss (models/heads/oicr.py). Same numpy inputs, f32 on both sides.

Tolerances: both sides compute the same f32 operations, summed in possibly
different orders, so values and gradients agree to a few f32 ulps
(rtol 1e-5, atol 1e-6); the matcher's outputs are discrete and exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.core.boxes import get_deltas as jax_get_deltas
from sos_wsod_tpu.core.boxes import unique_boxes_keep_mask as jax_unique_boxes_keep_mask
from sos_wsod_tpu.core.matcher import Matcher as JaxMatcher
from sos_wsod_tpu.models.heads import oicr as joicr
from sos_wsod_tpu.models.heads import wsddn as jwsddn
from sos_wsod_torch.core.boxes import get_deltas, pairwise_iou, unique_boxes_keep_mask
from sos_wsod_torch.core.matcher import Matcher
from sos_wsod_torch.models.heads import oicr, wsddn

TOL = dict(rtol=1e-5, atol=1e-6)


def _boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, size / 2, (n, 2))], 1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_get_deltas_matches_jax():
    """Including degenerate source and target boxes (w or h <= 0)."""
    rng = np.random.RandomState(0)
    src, tgt = _boxes(rng, 30), _boxes(rng, 30)
    src[0, 2] = src[0, 0]          # zero width
    tgt[1, 3] = tgt[1, 1] - 2      # negative height
    for weights in ((10.0, 10.0, 5.0, 5.0), (1.0, 1.0, 1.0, 1.0)):
        want = jax_get_deltas(jnp.asarray(src), jnp.asarray(tgt), weights)
        got = get_deltas(_t(src), _t(tgt), weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unique_boxes_keep_mask_matches_jax():
    rng = np.random.RandomState(1)
    boxes = np.round(_boxes(rng, 40), 1)
    boxes[10:15] = boxes[3]
    boxes[20] = boxes[3] + 0.2     # hashes equal after rounding
    got = unique_boxes_keep_mask(boxes)
    np.testing.assert_array_equal(got, jax_unique_boxes_keep_mask(boxes))
    assert got.sum() < 40 and got[3] and not got[10]


@pytest.mark.parametrize("case", ["mixed", "no_gt", "low_quality"])
def test_matcher_matches_jax(case):
    """Bands, invalid gt rows, the no-valid-gt branch and d2's
    allow_low_quality_matches quirk (a gt whose best IoU is 0 labels every
    zero-IoU prediction 1)."""
    rng = np.random.RandomState(2)
    gt, preds = _boxes(rng, 6), _boxes(rng, 50)
    preds[:6] = gt + rng.uniform(-3, 3, gt.shape).astype(np.float32)   # some high IoUs
    preds[6] = preds[7]                                                  # a tie
    gt_valid = np.array([True, True, False, True, True, False])
    low_quality = case == "low_quality"
    if case == "no_gt":
        gt_valid[:] = False
    if low_quality:
        gt[1] = [500.0, 500.0, 510.0, 510.0]   # overlaps no prediction
    iou = pairwise_iou(_t(gt), _t(preds))
    jm = JaxMatcher([0.5, 0.6], [0, -1, 1], allow_low_quality_matches=low_quality)
    tm = Matcher([0.5, 0.6], [0, -1, 1], allow_low_quality_matches=low_quality)
    want_m, want_l = jm(jnp.asarray(iou.numpy()), jnp.asarray(gt_valid))
    got_m, got_l = tm(iou, _t(gt_valid))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    if case == "no_gt":
        assert (got_l == 0).all() and (got_m == 0).all()
    if low_quality:
        assert (got_l == 1).sum() > 10


def _wsddn_inputs(seed, p=24, k=5):
    rng = np.random.RandomState(seed)
    c = rng.randn(p, k).astype(np.float32) * 2
    d = rng.randn(p, k).astype(np.float32) * 2
    valid = np.arange(p) < p - 5                   # padded slots at the end
    d[~valid] = 1e4                                # padded slots must not leak
    gt = np.zeros(k, np.float32)
    gt[[1, 3]] = 1
    return c, d, valid, gt


@pytest.mark.parametrize("mean_loss", [True, False])
def test_wsddn_mil_loss_values_and_grads_match_jax(mean_loss):
    """Scores, image scores, the MIL loss and its gradients w.r.t. both
    logit sets, with padded slots: their scores and gradients are 0 and
    finite."""
    c, d, valid, gt = _wsddn_inputs(3)

    def jax_loss(cc, dd):
        return jwsddn.mil_loss(jwsddn.wsddn_scores(cc, dd, jnp.asarray(valid)),
                               jnp.asarray(gt), mean_loss)

    want_scores = jwsddn.wsddn_scores(jnp.asarray(c), jnp.asarray(d), jnp.asarray(valid))
    want, (want_gc, want_gd) = jax.value_and_grad(jax_loss, (0, 1))(jnp.asarray(c),
                                                                    jnp.asarray(d))
    tc, td = _t(c).requires_grad_(True), _t(d).requires_grad_(True)
    scores = wsddn.wsddn_scores(tc, td, _t(valid))
    got = wsddn.mil_loss(scores, _t(gt), mean_loss)
    got.backward()
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_scores), **TOL)
    np.testing.assert_allclose(wsddn.mil_image_scores(scores).detach().numpy(),
                               np.asarray(jwsddn.mil_image_scores(want_scores)), **TOL)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want_gc), **TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_gd), **TOL)
    assert torch.isfinite(td.grad).all() and (td.grad[~_t(valid)] == 0).all()
    assert (scores[~_t(valid)] == 0).all()


def _branch_inputs(seed, p=30, k=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(p, k + 1).astype(np.float32)
    cls = rng.randint(-1, k + 1, p)                 # -1 ignore, k background
    weights = rng.uniform(0, 1, p).astype(np.float32)
    valid = rng.rand(p) > 0.2
    deltas = rng.randn(p, k * 4).astype(np.float32) * 0.5
    props = _boxes(rng, p)
    gts = props + rng.uniform(-5, 5, props.shape).astype(np.float32)
    return logits, cls, weights, valid, deltas, props, gts


def test_weighted_ce_loss_matches_jax():
    logits, cls, weights, valid, *_ = _branch_inputs(4)
    args = (cls, weights, valid)
    want, want_g = jax.value_and_grad(joicr.weighted_ce_loss)(
        jnp.asarray(logits), *(jnp.asarray(a) for a in args))
    tl = _t(logits).requires_grad_(True)
    got = oicr.weighted_ce_loss(tl, *(_t(a) for a in args))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("loss_type,beta", [("smooth_l1", 0.0), ("smooth_l1", 0.5),
                                            ("smooth_l1_weighted", 0.0),
                                            ("smooth_l1_mean", 0.1)])
def test_box_reg_loss_matches_jax(loss_type, beta):
    """All three loss types, and smooth-L1 with and without a beta."""
    _, cls, weights, valid, deltas, props, gts = _branch_inputs(5)
    k = deltas.shape[1] // 4
    sw = weights if loss_type == "smooth_l1_weighted" else None

    def jloss(dl):
        return joicr.box_reg_loss(dl, jnp.asarray(props), jnp.asarray(gts), jnp.asarray(cls),
                                  jnp.asarray(valid), num_classes=k, beta=beta,
                                  loss_type=loss_type,
                                  sample_weights=None if sw is None else jnp.asarray(sw))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(deltas))
    td = _t(deltas).requires_grad_(True)
    got = oicr.box_reg_loss(td, _t(props), _t(gts), _t(cls), _t(valid), num_classes=k,
                            beta=beta, loss_type=loss_type,
                            sample_weights=None if sw is None else _t(sw))
    got.backward()
    assert float(got) > 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_g), **TOL)
