"""The port's UWSOD family against the JAX package's, on the CPU in float32:
the models (sos_wsod_torch/models/meta/rcnn_uwsod.py: UWSODRCNN and
MRRPUWSODRCNN), the MRRP backbone and conv (models/backbones/mrrp.py), the
UWSOD ROI head and its mining and labelling functions (models/heads/uwsod.py),
and the RPN's level ids and its loss on tied anchors
(models/proposal_generator/rpn.py). One file, models first: the JAX side's
first eager run compiles each op, and the later tests, at the models'
shapes, reuse those programs.

For each model, from its JAX-initialised tree (conv biases made random,
the refinement branches' kernels scaled by 30 so that mining ranks are not
near-ties): the tree loads strictly with the model's DAN fc1 order and not
with the other; ``predict``'s scores and boxes equal JAX's; ``loss``'s
terms and the gradient of every parameter (the RPN head's among them: the
weakly-supervised RPN loss against the head's pseudo-GT) equal JAX's eager
``jax.value_and_grad`` of its ``loss``; then one SGD step, the port's
``solver/build.py`` against JAX's ``torch_sgd`` built from ``get_cfg()``
(lr 0.01, no warmup, on both sides), every parameter's update, and
``predict``'s detections, scores and boxes after the step. Images are 64 x
64 (UWSODRCNN's valid extent 60 x 64, the rest padding, which both mask),
3 classes, DAN 16/16, 2 regressing branches, RPN top-k 64/32. The head
alone takes the same widths (32 proposals, 7 x 7 x 512 pooled ROIs) in both
(refine_mist, sampling_on) settings of the JAX package's own head test.

The JAX DAN's dropout is replaced by the identity and the port's rate is 0;
JAX's sampling draws (the RPN's anchors, the head's subsampling) are fed to
the port in JAX's order through ``core/sampling.uniform``. The head takes
channels-last pooled ROIs on both sides; the port's are weighted by
``objectness_weight`` before the call, as its pooler does, where the JAX
head weights them itself. In the model tests the RPN's pseudo-GT (the last
branch's top-1 proposals and their regressed class boxes) is held against
JAX's: the same proposals, classes and valid flags, the boxes within the
box tolerance; then the port's RPN loss takes JAX's box bits. The reason: a
small pseudo-GT box inside several anchors of one size has the same IoU
with each of them in exact arithmetic, f32 breaks that tie by the box's
last bits, and the low-quality matches (every anchor at the best IoU) then
differ between two libraries whose features differ by 1e-5 relative (seen
with both seeds tried for the MRRP model: 15 positives against 3). Given
the same box bits the port's RPN loss equals JAX's, ties included
(``test_rpn_loss_on_tied_anchors_matches_jax``). The JAX ROIPool splits the
gradient of tied maxima where the port routes it to the first hit; the ties
here are the zeros of ReLU and of the padding, whose gradient the ReLU and
mask backward zero on both sides.

Tolerances: loss terms within rtol 1e-4 / atol 1e-5; gradients and updates
within rtol 1e-4 and 1e-5 of the leaf's largest entry (plus 1e-8); scores
within rtol 1e-4 / atol 1e-6; conv outputs within rtol 1e-4 and 1e-5 of
their largest entry; boxes within rtol 1e-4 / atol 1e-3 px (the RPN's
proposals and then the head's boxes are decoded through exp, whose f32
results differ between the two libraries in the last bits); integer
outputs, masks, mined indices, detection classes and valid flags exact.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.core.matcher import Matcher as JaxMatcher
from sos_wsod_tpu.models.backbones import mrrp as jax_mrrp
from sos_wsod_tpu.models.heads import uwsod as jax_uwsod
from sos_wsod_tpu.models.meta import rcnn_uwsod as jax_meta
from sos_wsod_tpu.models.proposal_generator import rpn as jax_rpn
from sos_wsod_tpu.solver.build import build_optimizer as jax_build_optimizer
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.core import sampling
from sos_wsod_torch.core.matcher import Matcher
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.backbones import mrrp
from sos_wsod_torch.models.heads import uwsod
from sos_wsod_torch.models.meta import MRRPUWSODRCNN, UWSODRCNN
from sos_wsod_torch.models.proposal_generator import rpn
from sos_wsod_torch.solver.build import build_optimizer
from test_torch_sampling import JaxDraws
from test_torch_single_view import _leaf, no_jax_dropout, one_thread  # noqa: F401 (fixtures)

K = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _flax_layout(grad: torch.Tensor) -> np.ndarray:
    a = grad.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a


def _assert_grads(module: torch.nn.Module, grads) -> None:
    n = 0
    for name, p in module.named_parameters():
        g = np.asarray(_leaf(grads, name))
        n += 1
        if not p.requires_grad:
            assert p.grad is None and not g.any(), name
            continue
        np.testing.assert_allclose(_flax_layout(p.grad), g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=name)
    assert n == len(jax.tree_util.tree_leaves(grads))


HW = 64
KW = dict(num_classes=3, refine_k=2, refine_reg=(True, True), dan_dims=(16, 16),
          pre_nms_topk=64, post_nms_topk=32, detections_per_image=10)
PORT = {"UWSODRCNN": UWSODRCNN, "MRRPUWSODRCNN": MRRPUWSODRCNN}
LR = 0.01


def _sample(seed, valid_hw):
    rng = np.random.RandomState(seed)
    img = np.zeros((HW, HW, 3), np.float32)
    img[:valid_hw[0], :valid_hw[1]] = rng.uniform(0, 255, tuple(valid_hw) + (3,))
    return {"image": img, "valid_hw": np.array(valid_hw, np.int32),
            "image_hw": np.array(valid_hw, np.int32),
            "gt_classes_oh": np.array([1, 0, 1], np.float32)}


def _jb(sample):
    return {k: jnp.asarray(v) for k, v in sample.items()}


def _tb(sample):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sample.items()}


def setup_model(name, valid_hw, seed=1):
    """(JAX model, its randomized params, the sample of ``seed``)."""
    sample = _sample(seed, valid_hw)
    jm = getattr(jax_meta, name)(**KW)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), _jb(sample), jax.random.PRNGKey(0),
                                    True)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(0)
    for stage in params["backbone"].values():
        for conv in stage.values():
            conv["bias"] = rng.normal(0, 0.05, conv["bias"].shape).astype(np.float32)
    for name_, sub in params["roi_heads"].items():
        if name_.startswith("box_refinery"):
            for leaf in sub.values():
                leaf["kernel"] = leaf["kernel"] * 30.0
    return jm, params, sample


def _port(name, params, channels_last=None):
    cls = PORT[name]
    order = cls.flax_dan_channels_last if channels_last is None else channels_last
    tm = cls(**KW, dan_dropout=0.0, device="meta")
    return load_weights(tm, state_dict_from_flax(params, dan_channels_last=order), "cpu")


def _flax_grad(tm, name, grad):
    """A port gradient in the JAX tree's layout (DAN fc1 back to (c, h, w)
    for a model that pools NCHW)."""
    a = grad.detach().numpy()
    if name == "roi_heads.dan.fc1.weight" and not tm.flax_dan_channels_last:
        out_dim, in_dim = a.shape
        a = a.reshape(out_dim, 49, in_dim // 49).transpose(0, 2, 1).reshape(out_dim, in_dim)
        return a.T
    return _flax_layout(grad)


def rpn_draws(key, n_anchors):
    """The JAX loss's draws: split(key, 3) gives the head's and the RPN's
    keys; the head draws nothing without sampling, the RPN's anchor
    sampling splits its key into the positives' and the negatives'."""
    _, _, rpn_key = jax.random.split(key, 3)
    k_pos, k_neg = jax.random.split(rpn_key)
    return [jax.random.uniform(k_pos, (n_anchors,)), jax.random.uniform(k_neg, (n_anchors,))]


def check_predict_and_weights(name, jm, params, sample):
    """The tree loads strictly; predict's scores and boxes equal JAX's with
    the model's fc1 order and differ with the other."""
    _, scores_j, boxes_j = jm.apply({"params": params}, _jb(sample), None, False)
    tm = _port(name, params)
    with torch.no_grad():
        _, scores, boxes = tm.predict(_tb(sample))
        wrong = _port(name, params, not tm.flax_dan_channels_last).predict(_tb(sample))[1]
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(boxes_j), rtol=1e-4, atol=1e-3)
    assert np.abs(wrong.numpy() - np.asarray(scores_j)).max() > 1e-3


def _jax_rpn_gt(jm, params, sample, key, monkeypatch):
    """The JAX loss's pseudo-GT for the RPN, from a forward pass."""
    seen = []
    losses = jax_uwsod.UWSODROIHead.losses

    def capture(self, *args, **kwargs):
        out = losses(self, *args, **kwargs)
        seen.append(jax.tree_util.tree_map(np.asarray, out[1]))
        return out

    with monkeypatch.context() as m:
        m.setattr(jax_uwsod.UWSODROIHead, "losses", capture)
        jm.apply({"params": params}, _jb(sample), key, True)
    return seen[0]


def _use_jax_box_bits(monkeypatch, jgt):
    """Make the port's head hand the RPN JAX's pseudo-GT boxes, after
    holding its own against them."""
    losses = uwsod.UWSODROIHead.losses

    def swap(self, *args, **kwargs):
        out, gt = losses(self, *args, **kwargs)
        for f in ("classes", "index", "valid"):
            np.testing.assert_array_equal(getattr(gt, f).numpy(), getattr(jgt, f), err_msg=f)
        np.testing.assert_allclose(gt.boxes.numpy(), jgt.boxes, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(gt.weights.numpy(), jgt.weights, rtol=1e-4, atol=1e-6)
        return out, dataclasses.replace(gt, boxes=torch.from_numpy(jgt.boxes.copy()))

    monkeypatch.setattr(uwsod.UWSODROIHead, "losses", swap)


def check_loss_step_predict(name, jm, params, sample, monkeypatch):
    key = jax.random.PRNGKey(5)
    jgt = _jax_rpn_gt(jm, params, sample, key, monkeypatch)
    assert jgt.valid.tolist() == [True, False, True]

    def total(p):
        losses = jm.apply({"params": p}, _jb(sample), key, True)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(total, has_aux=True)(params)
    grads = jax.tree_util.tree_map(np.asarray, grads)

    tm = _port(name, params).train()
    n_anchors = sum(a.shape[0] for a in tm.proposal_generator.anchors(
        [(7, 7)] * len(tm.levels), "cpu"))
    draws = JaxDraws(rpn_draws(key, n_anchors))
    monkeypatch.setattr(sampling, "uniform", draws)
    _use_jax_box_bits(monkeypatch, jgt)
    losses = tm.loss(_tb(sample))
    assert not draws.arrays
    assert set(losses) == set(want) == {"loss_cls", "loss_cls_r0", "loss_cls_r1",
                                        "loss_box_reg_r0", "loss_box_reg_r1", "loss_rpn_cls",
                                        "loss_rpn_loc"}
    for k in sorted(want):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert float(want[k]) > 0, k
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.SOLVER.BASE_LR, c.SOLVER.WARMUP_ITERS = LR, 0
    opt, _ = build_optimizer(cfg, tm)
    opt.zero_grad()
    sum(losses.values()).backward()
    before = {n: _flax_grad(tm, n, p.detach().clone()) for n, p in tm.named_parameters()}
    n_leaves = 0
    for n, p in tm.named_parameters():
        g = _leaf(grads, n)
        n_leaves += 1
        if n.split(".")[1] in ("plain1", "plain2"):
            assert p.grad is None and not p.requires_grad and not g.any(), n
            continue
        np.testing.assert_allclose(_flax_grad(tm, n, p.grad), g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=n)
        if n.startswith("proposal_generator.head."):
            assert np.abs(g).max() > 0, n
    assert n_leaves == len(jax.tree_util.tree_leaves(grads))
    opt.step()

    tx = jax_build_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(params), params)
    stepped = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    for n, p in tm.named_parameters():
        want_d = _leaf(stepped, n) - _leaf(params, n)
        got_d = _flax_grad(tm, n, p.detach()) - before[n]
        np.testing.assert_allclose(got_d, want_d, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want_d).max()) + 1e-8, err_msg=n)
    det_j, scores_j, boxes_j = jm.apply({"params": stepped}, _jb(sample), None, False)
    with torch.no_grad():
        det, scores, boxes = tm.eval().predict(_tb(sample))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(boxes_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(det_j.valid))
    v = det.valid.numpy()
    assert v.any()
    np.testing.assert_array_equal(det.classes.numpy()[v], np.asarray(det_j.classes)[v])
    np.testing.assert_allclose(det.scores.numpy()[v], np.asarray(det_j.scores)[v], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(det.boxes.numpy()[v], np.asarray(det_j.boxes)[v], rtol=1e-4,
                               atol=1e-3)


@pytest.fixture(scope="module")
def uwsod_model():
    return setup_model("UWSODRCNN", (60, 64))


def test_uwsod_weights_and_predict_match_jax(uwsod_model):
    check_predict_and_weights("UWSODRCNN", *uwsod_model)


def test_uwsod_loss_gradients_sgd_step_and_predict_match_jax(uwsod_model, monkeypatch):
    check_loss_step_predict("UWSODRCNN", *uwsod_model, monkeypatch)


@pytest.fixture(scope="module")
def mrrp_model():
    return setup_model("MRRPUWSODRCNN", (HW, HW))


def test_mrrp_weights_and_predict_match_jax(mrrp_model):
    check_predict_and_weights("MRRPUWSODRCNN", *mrrp_model)


def test_mrrp_loss_gradients_sgd_step_and_predict_match_jax(mrrp_model, monkeypatch):
    check_loss_step_predict("MRRPUWSODRCNN", *mrrp_model, monkeypatch)


def test_mrrp_vgg16_forward_and_gradient(mrrp_model):
    """MRRPVGG16 at full width on the MRRP model's normalized 64 x 64 image
    and backbone weights: the (3, 512, 7, 7) branches against JAX's (1, 3,
    7, 7, 512), and the gradient of every trainable parameter (plain3 to
    plain5, the shared plain5 weights among them) for a random linear
    function of the branches; plain1 and plain2 are frozen by
    requires_grad, where JAX stops their gradient."""
    jm, params, sample = mrrp_model
    params = params["backbone"]
    img = (sample["image"] - np.asarray(jm.pixel_mean, np.float32))[None]
    r = np.random.RandomState(2).randn(3, 7, 7, 512).astype(np.float32)

    def f(p):
        out = jax_mrrp.MRRPVGG16().apply({"params": p}, jnp.asarray(img))["plain5"]
        return jnp.sum(out[0] * r), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
    net = mrrp.MRRPVGG16()
    net.load_state_dict(state_dict_from_flax(params))
    out = net(_t(img).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert out.shape == (3, 512, 7, 7)
    (out * _t(r).permute(0, 3, 1, 2)).sum().backward()
    w = np.asarray(want)[0]
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), w, rtol=1e-4,
                               atol=1e-5 * float(np.abs(w).max()))
    assert not net.plain1.conv1.weight.requires_grad and net.plain3.conv1.weight.requires_grad
    _assert_grads(net, grads)


def _head_inputs(seed, p=32, ch=512):
    rng = np.random.RandomState(seed)
    pooled = rng.rand(p, 7, 7, ch).astype(np.float32)
    pts = rng.rand(p, 2) * 60
    boxes = np.concatenate([pts, pts + rng.rand(p, 2) * 20 + 4], 1).astype(np.float32)
    objectness = rng.randn(p).astype(np.float32)
    valid = np.arange(p) < p - 3
    gt_oh = np.array([1, 0, 1], np.float32)
    return pooled, boxes, objectness, valid, gt_oh


def _jax_head(mist, sampling_on):
    return jax_uwsod.UWSODROIHead(num_classes=K, refine_k=2, refine_reg=(True, True),
                                  refine_mist=mist, sampling_on=sampling_on, batch_sizes=(8, 8),
                                  positive_fractions=(0.5, 0.5), seed_cap=32, dan_dims=(16, 16))


def _port_head(params, mist, sampling_on):
    head = uwsod.UWSODROIHead(512 * 49, num_classes=K, refine_k=2, refine_reg=(True, True),
                              refine_mist=mist, sampling_on=sampling_on, batch_sizes=(8, 8),
                              positive_fractions=(0.5, 0.5), seed_cap=32, dan_dims=(16, 16),
                              dan_dropout=0.0)
    head.load_state_dict(state_dict_from_flax(params), strict=True)
    return head


def _head_params(jhead, inputs, key):
    params = jax.device_get(jhead.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs), key,
                                       method=jhead.losses)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, sub in params.items():
        if name.startswith("box_refinery"):
            for leaf in sub.values():
                leaf["kernel"] = leaf["kernel"] * 30.0
    return params


def head_draws(key, refine_k, p):
    """The JAX head's subsampling draws, in the order the port asks."""
    out = []
    for _ in range(refine_k):
        key, sub = jax.random.split(key)
        k_pos, k_neg = jax.random.split(sub)
        out += [jax.random.uniform(k_pos, (p,)), jax.random.uniform(k_neg, (p,))]
    return out


@pytest.mark.parametrize("mist,sampling_on", [(False, False), (True, True)])
def test_head_losses_rpn_gt_and_gradients_match_jax(monkeypatch, mist, sampling_on):
    """UWSODROIHead.losses in the JAX head test's two settings: every loss
    term, the RPN's pseudo-GT (boxes, classes, weights, index, valid) and
    the gradient of every parameter; then predict's mean softmax and boxes
    decoded by the mean deltas."""
    inputs = _head_inputs(0)
    pooled, boxes, objectness, valid, gt_oh = inputs
    key = jax.random.PRNGKey(7)
    jhead = _jax_head(mist, sampling_on)
    params = _head_params(jhead, inputs, key)

    def total(p):
        losses, rpn_gt = jhead.apply({"params": p}, *map(jnp.asarray, inputs), key,
                                     method=jhead.losses)
        return sum(losses.values()), (losses, rpn_gt)

    (_, (want, jgt)), grads = jax.value_and_grad(total, has_aux=True)(params)

    head = _port_head(params, mist, sampling_on).train()
    draws = JaxDraws(head_draws(key, 2, len(boxes)) if sampling_on else [])
    monkeypatch.setattr(sampling, "uniform", draws)
    w = uwsod.objectness_weight(_t(objectness))
    losses, gt = head.losses(_t(pooled) * w[:, None, None, None], _t(boxes), _t(valid), _t(gt_oh))
    assert not draws.arrays
    sum(losses.values()).backward()
    assert set(losses) == set(want) == {"loss_cls", "loss_cls_r0", "loss_cls_r1",
                                        "loss_box_reg_r0", "loss_box_reg_r1"}
    for k in sorted(want):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert float(want[k]) > 0, k
    for f in ("classes", "index", "valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(jgt, f)),
                                      err_msg=f)
    np.testing.assert_allclose(gt.boxes.numpy(), np.asarray(jgt.boxes), atol=1e-3)
    np.testing.assert_allclose(gt.weights.numpy(), np.asarray(jgt.weights), rtol=1e-4, atol=1e-6)
    assert int(gt.valid.sum()) == 2
    _assert_grads(head, grads)

    scores_j, boxes_j = jhead.apply({"params": params}, *map(jnp.asarray, inputs[:4]),
                                    method=jhead.predict)
    with torch.no_grad():
        scores, pred = head.eval().predict(_t(pooled) * w[:, None, None, None], _t(boxes),
                                           _t(valid))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pred.numpy(), np.asarray(boxes_j), atol=1e-3)
    assert pred.shape == (len(boxes), K * 4)


def test_rpn_return_levels_over_same_stride_levels():
    """find_top_rpn_proposals on 3 levels of one stride (the MRRP
    branches, at the MRRP model's 735 anchors a level and top-k 64 -> 32):
    the kept boxes, logits, valid flags and each slot's level, invalid
    slots included, equal JAX's. 9 logits a level are finite, so fewer
    proposals survive than the top-k has slots; level 2 holds copies of
    level 0's boxes and scores (the same anchors), which the per-level NMS
    keeps."""
    rng = np.random.RandomState(0)
    n, levels = 735, []
    for lvl in range(3):
        xy = rng.uniform(0, 50, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (n, 2))], 1).astype(np.float32)
        logits = np.full(n, -np.inf, np.float32)
        logits[rng.choice(n, 9, replace=False)] = rng.randn(9)
        levels.append(levels[0] if lvl == 2 else (logits, boxes))
    hw = np.array([60, 70], np.int32)
    kw = dict(pre_nms_topk=64, post_nms_topk=32, nms_thresh=0.7, return_levels=True)
    want = jax_rpn.find_top_rpn_proposals([jnp.asarray(l) for l, _ in levels],
                                          [jnp.asarray(b) for _, b in levels], jnp.asarray(hw),
                                          **kw)
    got = rpn.find_top_rpn_proposals([_t(l) for l, _ in levels], [_t(b) for _, b in levels],
                                     _t(hw), **kw)
    assert len(got) == 4
    for g, w, name in zip(got, want, ("boxes", "logits", "valid", "levels")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    valid, lvl = got[2].numpy(), got[3].numpy()
    assert 0 < valid.sum() < 32 and set(lvl[valid]) == {0, 1, 2}
    assert (lvl[valid] == 0).sum() == (lvl[valid] == 2).sum()
    assert len(rpn.find_top_rpn_proposals([_t(l) for l, _ in levels], [_t(b) for _, b in levels],
                                          _t(hw), **{**kw, "return_levels": False})) == 3


def test_mrrp_conv_forward_and_shared_weight_gradient():
    """One MRRPConv over 3 branches at dilations 1, 2, 3: the outputs and
    the gradients of the one weight and bias, against JAX's."""
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 11, 13, 8).astype(np.float32)            # (B, H, W, C)
    r = rng.randn(3, 11, 13, 6).astype(np.float32)
    jconv = jax_mrrp.MRRPConv(6, 3, (1, 2, 3))
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(xs))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.normal(0, 0.1, 6).astype(np.float32))}

    def f(p):
        out = jconv.apply({"params": p}, jnp.asarray(xs))
        return jnp.sum(out * r), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
    conv = mrrp.MRRPConv(8, 6, 3, (1, 2, 3))
    conv.load_state_dict(state_dict_from_flax(params))
    out = conv(_t(xs).permute(0, 3, 1, 2))
    (out * _t(r).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))
    _assert_grads(conv, grads)
    with pytest.raises(ValueError, match="branches"):
        conv(_t(xs[:2]).permute(0, 3, 1, 2))


def _class_boxes(rng, p, k):
    xy = rng.uniform(0, 50, (p, k, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 30, (p, k, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("class_specific", [False, True])
def test_top1_mining_and_labelling_match_jax(class_specific):
    """top1_mining_img_weighted then label_and_sample_boxes on (P, 4)
    proposals or (P, K, 4) class-specific boxes, with an absent class and
    invalid slots: the mined boxes, indices, weights and valid flags, and
    every proposal's class, weight, matched pseudo-GT box and foreground
    flag, against JAX's; the absent class is never valid."""
    rng = np.random.RandomState(3)
    p = 40
    scores = rng.uniform(0, 1, (p, K + 1)).astype(np.float32)
    props = _class_boxes(rng, p, 1)[:, 0]
    boxes = (props[:, None] + rng.uniform(-2, 2, (p, K, 4)).astype(np.float32)
             if class_specific else props)
    valid = np.arange(p) < p - 5
    scores[p - 2, 1] = 5.0                       # an invalid slot never wins
    gt_oh = np.array([1, 0, 1], np.float32)
    img = rng.uniform(0.1, 0.9, K).astype(np.float32)
    jgt = jax_uwsod.top1_mining_img_weighted(*map(jnp.asarray, (scores, boxes, valid, gt_oh,
                                                                img)))
    gt = uwsod.top1_mining_img_weighted(*map(_t, (scores, boxes, valid, gt_oh, img)))
    for f in ("boxes", "classes", "scores", "weights", "index", "valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(jgt, f)),
                                      err_msg=f)
    assert gt.valid.tolist() == [True, False, True] and int(gt.index[1]) != p - 2
    if class_specific:
        np.testing.assert_array_equal(gt.boxes.numpy()[2], boxes[int(gt.index[2]), 2])
    want = jax_uwsod.label_and_sample_boxes(jgt, jnp.asarray(props), jnp.asarray(valid),
                                            JaxMatcher([0.5, 0.6], [0, -1, 1]), K)
    got = uwsod.label_and_sample_boxes(gt, _t(props), _t(valid), Matcher([0.5, 0.6], [0, -1, 1]),
                                       K)
    for g, w, name in zip(got, want, ("cls", "weights", "gt_boxes", "fg")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[0].numpy() == K).any() and got[3].numpy().any()


def test_mist_mining_takes_class_zero_boxes_then_each_seed_class_box():
    """With refine_mist and (P, K, 4) boxes the head runs MIST's NMS on the
    boxes of class 0 for every class, then gives each seed its own class's
    box (the JAX package's rule): moving class 1's boxes changes no seed,
    only the seeds' boxes of class 1."""
    rng = np.random.RandomState(4)
    p = 32
    scores = _t(rng.uniform(0, 1, (p, K)).astype(np.float32))
    boxes = _class_boxes(rng, p, K)
    head = uwsod.UWSODROIHead(16, num_classes=K, refine_k=1, refine_reg=(True,),
                              refine_mist=True, dan_dims=(8, 8), seed_cap=32)
    valid, gt_oh = torch.ones(p, dtype=torch.bool), _t(np.array([1, 1, 0], np.float32))
    img = _t(np.full(K, 0.5, np.float32))
    a = head._mine(scores, _t(boxes), valid, gt_oh, img)
    moved = boxes.copy()
    moved[:, 1] += 7.0
    b = head._mine(scores, _t(moved), valid, gt_oh, img)
    assert torch.equal(a.index, b.index) and torch.equal(a.valid, b.valid)
    sel = a.valid & (a.classes == 1)
    assert bool(sel.any())
    np.testing.assert_array_equal(a.boxes[sel].numpy(), boxes[a.index[sel].numpy(), 1])
    np.testing.assert_array_equal(b.boxes[sel].numpy(), moved[a.index[sel].numpy(), 1])
    jgt = jax_uwsod.UWSODROIHead(num_classes=K, refine_k=1, refine_reg=(True,), refine_mist=True,
                                 seed_cap=32)._mine(
        jnp.asarray(scores.numpy()), jnp.asarray(boxes), jnp.ones(p, bool),
        jnp.asarray(gt_oh.numpy()), jnp.asarray(img.numpy()))
    for f in ("boxes", "classes", "index", "valid"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(jgt, f)),
                                      err_msg=f)


def test_objectness_weight():
    """sigmoid(objectness + 1) for the learned RPN's proposals, objectness
    + 1 otherwise, in f32."""
    x = torch.tensor([-3.0, 0.0, 2.5], dtype=torch.bfloat16)
    assert torch.equal(uwsod.objectness_weight(x), torch.sigmoid(x.float() + 1.0))
    assert torch.equal(uwsod.objectness_weight(x, rpn_on=False), x.float() + 1.0)


def test_rpn_loss_on_tied_anchors_matches_jax(monkeypatch):
    """The RPN's loss against a small pseudo-GT box inside several anchors
    of one size (equal IoUs, the low-quality matches' tie) on three
    same-stride levels of identical anchors, with JAX's draws: both losses
    and the sampled anchors equal JAX's."""
    from sos_wsod_tpu.models.anchors import AnchorGenerator as JaxAnchors

    sizes, ratios = ((32, 64, 128, 256, 512),) * 3, ((0.5, 1.0, 2.0),) * 3
    anchors = np.concatenate(JaxAnchors(sizes, ratios, [8, 8, 8])([(7, 7)] * 3)).astype(np.float32)
    n = anchors.shape[0]
    gt = np.array([[0.4, 0.0, 25.7, 4.9], [30.0, 28.0, 40.0, 36.0], [0, 0, 0, 0]], np.float32)
    gt_valid = np.array([True, True, False])
    rng = np.random.RandomState(5)
    logits, deltas = rng.randn(n).astype(np.float32), rng.randn(n, 4).astype(np.float32) * 0.1
    key = jax.random.PRNGKey(3)
    k_pos, k_neg = jax.random.split(key)
    jm = JaxMatcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)
    want = jax_rpn.rpn_losses(*map(jnp.asarray, (logits, deltas, anchors, gt, gt_valid)), jm, key)
    monkeypatch.setattr(sampling, "uniform", JaxDraws([jax.random.uniform(k_pos, (n,)),
                                                       jax.random.uniform(k_neg, (n,))]))
    got = rpn.rpn_losses(*map(_t, (logits, deltas, anchors, gt, gt_valid)),
                         Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True), None)
    for k in ("loss_rpn_cls", "loss_rpn_loc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    iou = np.asarray(jax_uwsod.box_ops.pairwise_iou(jnp.asarray(gt), jnp.asarray(anchors)))[0]
    assert (iou == iou.max()).sum() >= 6   # the tie, across the three levels
