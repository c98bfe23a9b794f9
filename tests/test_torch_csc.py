"""The port's CSC op and head (sos_wsod_torch/ops/csc.py,
sos_wsod_torch/models/heads/csc.py) against the JAX package's on the CPU in
float32:
  - ``csc`` on the inputs of tests/test_csc.py:test_csc_parity (seeds 0-2)
    and on maps of one peak a class (most cells below the threshold, so
    that the scores take both signs), invalid ROIs among them: W, PL and NL
    exact; an absent class keeps W = 1;
  - ``csc_constraint``'s gradient: W's positive part, or its negated
    negative part, and none to W;
  - ``compute_cpg`` on the linear model of tests/test_csc.py:119 and on a
    nonlinear one whose maps vary by pixel: within rtol 1e-5 / atol 1e-6
    (two f32 backward passes), the gated classes exactly zero;
  - ``CSCROIHead``: both loss terms and every parameter gradient, with the
    constraints on and past CSC_MAX_ITER (W_pos = 1, W_neg = 0), within
    rtol 1e-4 / atol 1e-5 (losses) and rtol 1e-4 plus 1e-5 of the leaf's
    largest entry (gradients); predict's scores within rtol 1e-5.
The heads' dropout is off (the JAX DAN's replaced by the identity).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.heads import csc as jax_csc_head
from sos_wsod_tpu.models.heads import dan as jax_dan
from sos_wsod_tpu.ops.csc import csc as jax_csc_op, csc_constraint as jax_csc_constraint
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.models.heads.csc import CSCROIHead, compute_cpg
from sos_wsod_torch.ops.csc import csc, csc_constraint


@pytest.fixture(autouse=True)
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jax_dan, "HwDropout", lambda rate: (lambda x, deterministic: x))


def _csc_inputs(seed, sparse):
    rng = np.random.RandomState(seed)
    c, h, w, n = 4, 48, 64, 24
    cpgs = rng.rand(c, h, w).astype(np.float32)
    if sparse:      # a peak a class, as a CPG map has
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.rand(c, 1, 1) * h, rng.rand(c, 1, 1) * w
        cpgs = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 60.0).astype(np.float32)
    labels = (rng.rand(c) > 0.4).astype(np.float32)
    labels[0] = 1.0
    preds = rng.uniform(0.8 if sparse else 0.1, 0.95, c).astype(np.float32)
    pts = rng.rand(n, 2) * np.array([w - 12, h - 12])
    wh = rng.rand(n, 2) * 20 + 4
    rois = np.concatenate([pts, pts + wh], 1).astype(np.float32)
    valid = np.arange(n) < (n - 3 if sparse else n)
    return cpgs, labels, preds, rois, valid


@pytest.mark.parametrize("seed,sparse", [(0, False), (1, False), (2, False), (3, True),
                                         (4, True)])
def test_csc_is_exact(seed, sparse):
    args = _csc_inputs(seed, sparse)
    want = jax_csc_op(*map(jnp.asarray, args))
    got = csc(*map(torch.from_numpy, args))
    for g, w, name in zip(got, want, ("W", "PL", "NL")):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    w = got[0].numpy()
    if sparse:      # both signs (confident classes), and the invalid ROIs at 1
        assert (w < 0).any() and (w > 0).any() and (w[-3:] == 1).all()


def test_csc_absent_class_all_ones():
    cpgs = np.random.RandomState(0).rand(2, 16, 16).astype(np.float32)
    w, pl, nl = csc(torch.from_numpy(cpgs), torch.tensor([0.0, 1.0]), torch.tensor([0.9, 0.9]),
                    torch.tensor([[2.0, 2, 10, 10]]), torch.tensor([True]))
    assert w[0, 0] == 1.0 and pl.tolist() == [0.0, 1.0] and nl.tolist() == [0.0, 0.0]


def test_csc_constraint_gradient():
    x = torch.from_numpy(np.random.RandomState(0).rand(6, 3).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(6, 3).astype(np.float32))
    for polar, want in ((True, w.clamp(min=0)), (False, -w.clamp(max=0))):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = csc_constraint(xx, ww, polar)
        torch.testing.assert_close(y, x * want, rtol=0, atol=0)
        y.sum().backward()
        torch.testing.assert_close(xx.grad, want, rtol=0, atol=0)
        assert ww.grad is None
        gj = jax.grad(lambda a: jnp.sum(jax_csc_constraint(a, jnp.asarray(w.numpy()),
                                                                polar)))(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(xx.grad.numpy(), np.asarray(gj))


@pytest.mark.parametrize("nonlinear", [False, True])
def test_compute_cpg_matches_jax(nonlinear):
    """scores = image @ M over the pixels (tests/test_csc.py:119; every map
    is the constant max |M[:, c]|, normalised to 1), or tanh(image @ M1) @
    M2; class 1 present with a score under tau, class 3 absent."""
    h, w, ch, c = 8, 10, 3, 4
    rng = np.random.RandomState(0)
    m1 = rng.randn(ch, 6 if nonlinear else c).astype(np.float32)
    m2 = rng.randn(6, c).astype(np.float32)
    image = rng.rand(h, w, ch).astype(np.float32)
    gt = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    preds = np.array([0.9, 0.2, 0.7, 0.9], np.float32)

    def jax_fn(im):
        s = im.reshape(-1, ch) @ jnp.asarray(m1)
        return jnp.tanh(s) @ jnp.asarray(m2) if nonlinear else s

    want = np.asarray(jax_csc_head.compute_cpg(jax_fn, jnp.asarray(image), jnp.asarray(gt),
                                               jnp.asarray(preds), tau=0.7))
    im = torch.from_numpy(image).requires_grad_()
    s = im.reshape(-1, ch) @ torch.from_numpy(m1)
    scores = torch.tanh(s) @ torch.from_numpy(m2) if nonlinear else s
    got = compute_cpg(scores, im, torch.from_numpy(gt), torch.from_numpy(preds), tau=0.7).numpy()
    assert got.shape == (c, h, w) and not got[[1, 3]].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[[0, 2]].max() == 1.0 and (got[0].min() < 1.0) == nonlinear


def _head_inputs(seed, p=16, classes=3, ch=8, imhw=32):
    rng = np.random.RandomState(seed)
    pooled = rng.rand(p, 7, 7, ch).astype(np.float32)
    pts = rng.rand(p, 2) * (imhw - 12)
    wh = rng.rand(p, 2) * 10 + 2
    boxes = np.concatenate([pts, pts + wh], 1).astype(np.float32)
    objectness = rng.rand(p).astype(np.float32)
    valid = np.arange(p) < p - 2
    gt = np.zeros(classes, np.float32)
    gt[[0, 2]] = 1
    cpgs = (rng.rand(classes, imhw, imhw) ** 6).astype(np.float32)
    return pooled, boxes, objectness, valid, gt, cpgs


@pytest.mark.parametrize("use_csc", [True, False])
def test_csc_head_losses_and_gradients_match_jax(use_csc):
    pooled, boxes, obj, valid, gt, cpgs = _head_inputs(0)
    jh = jax_csc_head.CSCROIHead(num_classes=3, dan_dims=(32, 32))
    args = [jnp.asarray(a) for a in (pooled, boxes, obj, valid, gt, cpgs)]
    params = jh.init(jax.random.PRNGKey(0), *args, jnp.asarray(True), method=jh.losses)["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))

    def total(p):
        losses = jh.apply({"params": p}, *args, jnp.asarray(use_csc), method=jh.losses)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(total, has_aux=True)(params)

    th = CSCROIHead(7 * 7 * 8, 3, dan_dims=(32, 32), dan_dropout=0.0)
    th.load_state_dict(state_dict_from_flax(params), strict=True)
    scaled = torch.from_numpy(pooled * (obj + 1.0)[:, None, None, None])
    t = [torch.from_numpy(a) for a in (boxes, valid, gt, cpgs)]
    losses = th.losses(scaled, t[0], t[1], t[2], t[3], use_csc)
    sum(losses.values()).backward()
    assert set(losses) == set(want) == {"loss_cls_pos", "loss_cls_neg"}
    for k in want:
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    if not use_csc:
        assert losses["loss_cls_neg"].item() == 0.0
    for name, prm in th.named_parameters():
        mod, layer, leaf = name.split(".")
        g = np.asarray(grads[mod][layer]["kernel" if leaf == "weight" else "bias"])
        got = prm.grad.numpy()
        np.testing.assert_allclose(got.T if got.ndim == 2 else got, g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=name)

    want_scores, _ = jh.apply({"params": params}, args[0], args[1], args[2], args[3],
                              method=jh.predict)
    with torch.no_grad():
        scores, got_boxes = th.eval().predict(scaled, t[0], t[1])
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got_boxes.numpy(), boxes)
