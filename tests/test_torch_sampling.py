"""The port's stage-2 sampling and losses (sos_wsod_torch/core/sampling.py,
models/proposal_generator/rpn.py, models/roi_heads/standard.py) against the
JAX package's, on the CPU in f32, on the same numpy inputs and the same
random draws.

The two frameworks draw different numbers from one seed, so every uniform
the port draws (``core/sampling.py:uniform``) is replaced by JAX's, made
from the JAX function's key in the JAX function's order: subsample_masks
splits its key into the positives' and the negatives' keys;
label_and_sample_proposals then draws its compaction noise on its own key.

Tolerances: the sampled masks, rows, classes and matches are equal exactly
(the same f32 compares and a stable sort on both sides). The losses are sums
of a few hundred f32 terms taken in another order: rtol 1e-6 / atol 1e-7.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.core.matcher import Matcher as JaxMatcher
from sos_wsod_tpu.core.sampling import subsample_labels as jax_subsample_labels
from sos_wsod_tpu.core.sampling import subsample_masks as jax_subsample_masks
from sos_wsod_tpu.models.proposal_generator.rpn import (
    label_and_sample_anchors as jax_label_and_sample_anchors,
    rpn_losses as jax_rpn_losses,
)
from sos_wsod_tpu.models.roi_heads.standard import (
    add_ground_truth_to_proposals as jax_add_gt,
    fast_rcnn_losses as jax_fast_rcnn_losses,
    label_and_sample_proposals as jax_label_and_sample_proposals,
)
from sos_wsod_torch.core import sampling
from sos_wsod_torch.core.matcher import Matcher
from sos_wsod_torch.models.proposal_generator.rpn import label_and_sample_anchors, rpn_losses
from sos_wsod_torch.models.roi_heads.standard import (
    add_ground_truth_to_proposals,
    fast_rcnn_losses,
    label_and_sample_proposals,
)

RTOL, ATOL = 1e-6, 1e-7


class JaxDraws:
    """Stands in for ``sampling.uniform``: hands out JAX's draws in order,
    each checked against the shape the port asks for."""

    def __init__(self, arrays):
        self.arrays = [np.asarray(a) for a in arrays]

    def __call__(self, shape, generator, device):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a.copy()).to(device)


def subsample_draws(key, n):
    k_pos, k_neg = jax.random.split(key)
    return [jax.random.uniform(k_pos, (n,)), jax.random.uniform(k_neg, (n,))]


@pytest.fixture
def draws(monkeypatch):
    def install(arrays):
        d = JaxDraws(arrays)
        monkeypatch.setattr(sampling, "uniform", d)
        return d
    return install


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n_pos,n_neg,num,frac", [(40, 500, 256, 0.5), (300, 500, 256, 0.5),
                                                  (5, 10, 256, 0.25), (0, 80, 64, 0.25),
                                                  (90, 0, 64, 0.5)])
def test_subsample_masks_matches_jax(draws, n_pos, n_neg, num, frac):
    rng = np.random.default_rng(n_pos + n_neg)
    n = 1000
    perm = rng.permutation(n)
    pos = np.zeros(n, bool)
    neg = np.zeros(n, bool)
    pos[perm[:n_pos]] = True
    neg[perm[n_pos:n_pos + n_neg]] = True
    key = jax.random.PRNGKey(n_pos)
    want = jax_subsample_masks(jnp.asarray(pos), jnp.asarray(neg), num, frac, key)
    d = draws(subsample_draws(key, n))
    got = sampling.subsample_masks(*_t(pos, neg), num, frac, None)
    assert not d.arrays
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) == min(int(num * frac), n_pos)
    assert int(got[1].sum()) == min(num - int(got[0].sum()), n_neg)


def test_subsample_labels_matches_jax(draws):
    """Labels -1 (ignored), 0 (negative) and 1 (positive)."""
    labels = np.random.default_rng(4).integers(-1, 2, 500).astype(np.int8)
    key = jax.random.PRNGKey(4)
    want = jax_subsample_labels(jnp.asarray(labels), 128, 0.25, key)
    draws(subsample_draws(key, 500))
    got = sampling.subsample_labels(torch.from_numpy(labels), 128, 0.25, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not (got[0] & got[1]).any() and int(got[0].sum()) == 32


def _boxes(rng, n, size=200.0, lo=4.0, hi=120.0):
    xy = rng.uniform(0, size - lo, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(np.float32)


def _gt(rng, g=6, n_valid=4):
    gt = _boxes(rng, g, lo=20.0, hi=100.0)
    valid = np.arange(g) < n_valid
    classes = rng.integers(0, 20, g).astype(np.int32)
    return gt, classes, valid


@pytest.mark.parametrize("beta,n_valid", [(0.0, 4), (0.0, 0), (0.5, 3)])
def test_rpn_losses_match_jax(draws, beta, n_valid):
    """The anchors' sampled masks and matches equal; both losses within
    RTOL/ATOL, with L1 (beta 0, the config's) and smooth L1, and with no
    valid gt (every anchor negative)."""
    rng = np.random.default_rng(int(beta * 10) + n_valid)
    n = 600
    anchors = _boxes(rng, n)
    # anchors that overlap the gt well, so that positives exist
    gt, _, valid = _gt(rng, n_valid=n_valid)
    anchors[:24] = gt[np.arange(24) % len(gt)] + rng.normal(0, 3, (24, 4)).astype(np.float32)
    logits = rng.normal(0, 2, n).astype(np.float32)
    deltas = rng.normal(0, 0.5, (n, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jm = JaxMatcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)
    pm = Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)
    kw = dict(batch_size_per_image=256, positive_fraction=0.5)
    want_masks = jax_label_and_sample_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                              jnp.asarray(valid), jm, rng=key, **kw)
    want = jax_rpn_losses(jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors),
                          jnp.asarray(gt), jnp.asarray(valid), jm, key, smooth_l1_beta=beta, **kw)
    draws(subsample_draws(key, n) * 2)
    got_masks = label_and_sample_anchors(*_t(anchors, gt, valid), pm, generator=None, **kw)
    got = rpn_losses(*_t(logits, deltas, anchors, gt, valid), pm, None, smooth_l1_beta=beta, **kw)
    for g, w in zip(got_masks, want_masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    assert (int(got_masks[0].sum()) > 0) == (n_valid > 0)


@pytest.mark.parametrize("loss_type", ["CrossEntropy", "FocalLoss"])
@pytest.mark.parametrize("reg", ["smooth_l1", "smooth_l1_mean"])
@pytest.mark.parametrize("agnostic", [False, True])
def test_fast_rcnn_losses_match_jax(loss_type, reg, agnostic):
    rng = np.random.default_rng([loss_type == "FocalLoss", reg == "smooth_l1_mean", agnostic])
    s, k = 64, 20
    scores = rng.normal(0, 3, (s, k + 1)).astype(np.float32)
    deltas = rng.normal(0, 1, (s, 4 if agnostic else 4 * k)).astype(np.float32)
    boxes = _boxes(rng, s)
    gt_boxes = _boxes(rng, s)
    valid = rng.uniform(0, 1, s) > 0.2
    classes = np.where(rng.uniform(0, 1, s) > 0.6, rng.integers(0, k, s), k).astype(np.int32)
    classes = np.where(valid, classes, k).astype(np.int32)
    fg = valid & (classes < k)
    kw = dict(num_classes=k, box_reg_loss_type=reg, loss_type=loss_type)
    want = jax_fast_rcnn_losses(*[jnp.asarray(a) for a in (scores, deltas, boxes, classes,
                                                          gt_boxes, valid, fg)], **kw)
    got = fast_rcnn_losses(*_t(scores, deltas, boxes, classes, gt_boxes, valid, fg), **kw)
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg"}
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_add_ground_truth_to_proposals_matches_jax():
    rng = np.random.default_rng(0)
    props, logits, pvalid = _boxes(rng, 10), rng.normal(size=10).astype(np.float32), \
        rng.uniform(size=10) > 0.3
    gt, _, gvalid = _gt(rng)
    want = jax_add_gt(*[jnp.asarray(a) for a in (props, logits, pvalid, gt, gvalid)])
    got = add_ground_truth_to_proposals(*_t(props, logits, pvalid, gt, gvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("p,n_valid,batch", [(200, 4, 64), (40, 4, 64), (200, 0, 32)])
def test_label_and_sample_proposals_picks_the_same_rows(draws, p, n_valid, batch):
    """Rows, classes, matches, validity, foreground and the counts equal
    JAX's exactly, with the gt appended as the JAX heads append it; fewer
    proposals than the batch, and no valid gt (every row background)."""
    rng = np.random.default_rng(p + n_valid)
    props = _boxes(rng, p)
    pvalid = rng.uniform(0, 1, p) > 0.1
    gt, classes, gvalid = _gt(rng, n_valid=n_valid)
    props[:12] = gt[np.arange(12) % len(gt)] + rng.normal(0, 4, (12, 4)).astype(np.float32)
    logits = rng.normal(size=p).astype(np.float32)
    jb, _, jv = jax_add_gt(*[jnp.asarray(a) for a in (props, logits, pvalid, gt, gvalid)])
    key = jax.random.PRNGKey(p)
    kw = dict(batch_size_per_image=batch, positive_fraction=0.25, num_classes=20)
    want = jax_label_and_sample_proposals(jb, jv, jnp.asarray(gt), jnp.asarray(classes),
                                          jnp.asarray(gvalid), JaxMatcher([0.5], [0, 1]), key,
                                          **kw)
    n = jb.shape[0]
    d = draws(subsample_draws(key, n) + [jax.random.uniform(key, (n,))])
    pb, _, pv = add_ground_truth_to_proposals(*_t(props, logits, pvalid, gt, gvalid))
    got = label_and_sample_proposals(pb, pv, *_t(gt, classes, gvalid), Matcher([0.5], [0, 1]),
                                     None, **kw)
    assert not d.arrays
    for name, g, w in zip(("boxes", "classes", "match", "valid", "fg"), got[:5], want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for k in ("num_fg", "num_bg"):
        assert int(got[5][k]) == int(want[5][k])
    assert got[0].shape == (min(batch, n), 4)
    assert (int(got[5]["num_fg"]) > 0) == (n_valid > 0)
