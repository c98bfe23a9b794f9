"""The port's pseudo-GT mining and IoU labelling
(sos_wsod_torch/models/heads/oicr_plus.py) against the reference golden and
the JAX package: mist_mining, top_k_mining, mist_mining_wetectron and
label_and_sample. Mining is discrete: seed sets, classes, indices, validity
and labels must be equal exactly; gathered scores and boxes are copies of
the inputs and equal bit for bit.
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_golden_case import NUM_CLASSES, REFINE_K, build_train_case
from sos_wsod_tpu.core.matcher import Matcher as JaxMatcher
from sos_wsod_tpu.models.heads import oicr_plus as jop
from sos_wsod_torch.core.matcher import Matcher
from sos_wsod_torch.models.heads import oicr_plus as top

GOLD = pathlib.Path(__file__).parent / "goldens" / "oicr_plus_train.npz"
FIELDS = ("boxes", "classes", "scores", "weights", "index", "valid")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def golden():
    _, _, boxes4, _, gt_oh, _ = build_train_case()
    return np.load(GOLD), boxes4[0], gt_oh


@pytest.mark.parametrize("k", range(REFINE_K))
def test_mining_and_labels_match_reference_golden(golden, k):
    """Each round's mined seed set, per-proposal labels, weights and indices
    from the golden's recorded prev scores, with the assertions of the JAX
    package's test (tests/test_reference_goldens.py:394-417)."""
    z, boxes0, gt_oh = golden
    p = boxes0.shape[0]
    pv = torch.ones(p, dtype=torch.bool)
    gt = top.mist_mining(_t(z[f"prev_r{k}"]), _t(boxes0), pv, _t(gt_oh),
                         mist_p=0.10, mist_thre=0.05, seed_cap=64)
    got = {(int(c), int(i)) for c, i, v in zip(gt.classes, gt.index, gt.valid) if v}
    want = set(zip(z[f"seed_cls_r{k}"].tolist(), z[f"seed_idx_r{k}"].tolist()))
    assert got == want, f"round {k} seed set: {got} != {want}"
    cls, weights, index, _ = top.label_and_sample(gt, _t(boxes0), pv, Matcher([0.5, 0.6], [0, -1, 1]),
                                                  NUM_CLASSES)
    np.testing.assert_array_equal(cls.numpy(), z[f"labels_r{k}"])
    np.testing.assert_allclose(weights.numpy(), z[f"weights_r{k}"], rtol=1e-5, atol=1e-7)
    fg = z[f"labels_r{k}"] >= 0
    np.testing.assert_array_equal(index.numpy()[fg], z[f"index_r{k}"][fg])


def _case(seed, p=200, k=6, ties=False):
    """Scores with padded slots, 3 present classes; ``ties`` quantizes the
    scores so many proposals tie bitwise."""
    rng = np.random.RandomState(seed)
    scores = rng.dirichlet(np.ones(k + 1) * 0.3, p).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    xy = rng.uniform(0, 200, (p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 120, (p, 2))], 1).astype(np.float32)
    boxes[10:20] = boxes[0] + rng.uniform(-2, 2, (10, 4)).astype(np.float32)  # a dense cluster
    valid = np.arange(p) < p - 17
    gt_oh = np.zeros(k, np.float32)
    gt_oh[[0, 2, 5]] = 1
    return scores, boxes, valid, gt_oh


def _assert_same_gt(got, want):
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mist_p,seed_cap", [(0.10, 1024), (0.5, 16)])
def test_mist_mining_matches_jax(ties, mist_p, seed_cap):
    """"nms" MIST: with seed_cap 16 the 3 x 91 candidates overflow the cap
    and the rank-0 bonus keeps every present class's top-1; with quantized
    scores the ranking ties break to the lower index."""
    scores, boxes, valid, gt_oh = _case(7, ties=ties)
    args = (scores, boxes, valid, gt_oh)
    kw = dict(mist_p=mist_p, mist_thre=0.05, seed_cap=seed_cap)
    want = jop.mist_mining(*(jnp.asarray(a) for a in args), **kw)
    got = top.mist_mining(*(_t(a) for a in args), **kw)
    _assert_same_gt(got, want)
    assert got.valid.any()
    if seed_cap == 16:
        top1 = {int(np.argmax(np.where(valid, scores[:, c], -np.inf))) for c in (0, 2, 5)}
        assert top1 <= set(got.index.tolist())


@pytest.mark.parametrize("ties", [False, True])
def test_top_k_mining_matches_jax(ties):
    scores, boxes, valid, gt_oh = _case(8, ties=ties)
    args = (scores, boxes, valid, gt_oh)
    _assert_same_gt(top.top_k_mining(*(_t(a) for a in args)),
                    jop.top_k_mining(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed_cap", [1024, 8])
def test_wetectron_mining_matches_jax(ties, seed_cap):
    scores, boxes, valid, gt_oh = _case(9, ties=ties)
    args = (scores, boxes, valid, gt_oh)
    kw = dict(mist_p=0.25, mist_thre=0.05, seed_cap=seed_cap)
    got = top.mist_mining_wetectron(*(_t(a) for a in args), **kw)
    _assert_same_gt(got, jop.mist_mining_wetectron(*(jnp.asarray(a) for a in args), **kw))
    assert got.valid.any()


@pytest.mark.parametrize("mining", ["nms", "top_k", "wetectron", "no_gt"])
def test_label_and_sample_matches_jax(mining):
    """Classes (-1 ignore, K background), weights, indices and the fg mask,
    on each mining type's pseudo-GT and on pseudo-GT with no valid row."""
    scores, boxes, valid, gt_oh = _case(10)
    if mining == "no_gt":
        gt_oh[:] = 0
    jargs = tuple(jnp.asarray(a) for a in (scores, boxes, valid, gt_oh))
    targs = tuple(_t(a) for a in (scores, boxes, valid, gt_oh))
    fn = {"nms": "mist_mining", "top_k": "top_k_mining", "wetectron": "mist_mining_wetectron",
          "no_gt": "mist_mining"}[mining]
    jgt, tgt = getattr(jop, fn)(*jargs), getattr(top, fn)(*targs)
    k = gt_oh.shape[0]
    want = jop.label_and_sample(jgt, jnp.asarray(boxes), jnp.asarray(valid),
                                JaxMatcher([0.5, 0.6], [0, -1, 1]), k)
    got = top.label_and_sample(tgt, _t(boxes), _t(valid), Matcher([0.5, 0.6], [0, -1, 1]), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert (got[0] == k).any()
    assert (got[1] > 0).any() == (mining != "no_gt")
