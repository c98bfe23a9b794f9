"""The port's WSJDS pieces against the JAX package's, on the CPU in float32:
the ASPP head and its functions (sos_wsod_torch/models/heads/aspp.py), the
dense CRF (sos_wsod_torch/ops/dense_crf.py, built from the port's own copy of
the C++ source) and the WSJDS ROI head (models/heads/wsjds.py). The model,
its training step and the CLI: tests/test_torch_single_view_wsjds.py and
tests/test_torch_cli_wsjds.py.

Inputs come from numpy seeds; weights cross from the JAX trees through
``engine/weights.py:state_dict_from_flax``. Dropout is off on both sides:
the JAX DAN's is replaced by the identity (as in
tests/test_torch_single_view.py) and so is the ASPP branches' flax
``nn.Dropout``, in this file only.

Tolerances: the ASPP head and ``resize_bilinear`` within rtol 1e-5 / atol
2e-6 (f32 convolutions summed in other orders; the bilinear weights agree
to 2.4e-7 at x8); ``seg_targets_from_cpg`` exact; ``sem_seg_loss`` and
``constraint_loss`` within rtol 1e-5; the CRF bit-identical (the same
source, compiler and flags); the head's loss terms within rtol 1e-4 / atol
1e-5 and its gradients within rtol 1e-4 plus 1e-5 of the leaf's largest
entry (plus 1e-8), as in tests/test_torch_single_view_csc.py; the masks
within rtol 1e-5 / atol 2e-6 and ``crop_instance_masks`` exact.
"""
from __future__ import annotations

import functools
import importlib
import pathlib

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.heads import aspp as jax_aspp
from sos_wsod_tpu.models.heads import wsjds as jax_wsjds
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.kernels import build
from sos_wsod_torch.models.heads import aspp, wsjds
from test_torch_single_view import _flax_grad, no_jax_dropout, one_thread  # noqa: F401

jax_crf = importlib.import_module("sos_wsod_tpu.ops.dense_crf")
port_crf = importlib.import_module("sos_wsod_torch.ops.dense_crf")
ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 3


@pytest.fixture(autouse=True)
def no_aspp_dropout(monkeypatch):
    """The ASPP branches call flax's ``nn.Dropout`` directly: the identity."""
    monkeypatch.setattr(flax_nn, "Dropout", lambda rate, deterministic: (lambda x: x))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _aspp_pair(c, conv_dims=(8, 8), mask_softmax=False, hw=(6, 8), seed=0):
    """The JAX ASPPHead's own init on (hw, c) features, its random biases,
    and the port's head with those weights."""
    rng = np.random.RandomState(seed)
    feats = rng.uniform(-1, 2, hw + (c,)).astype(np.float32)
    jh = jax_aspp.ASPPHead(num_classes=K, conv_dims=conv_dims, mask_softmax=mask_softmax)
    params = jax.tree_util.tree_map(np.array, jh.init(jax.random.PRNGKey(seed),
                                                      jnp.asarray(feats))["params"])
    for branch in params.values():
        for conv in branch.values():
            conv["bias"] = rng.normal(0, 0.1, conv["bias"].shape).astype(np.float32)
    th = aspp.ASPPHead(c, K, conv_dims, mask_softmax=mask_softmax, device="meta")
    th.to_empty(device="cpu")
    th.load_state_dict(state_dict_from_flax(params), strict=True)
    return jh, params, th.eval(), feats


@pytest.mark.parametrize("mask_softmax", [False, True])
def test_aspp_head_matches_jax(mask_softmax):
    """The max pool, the four dilated branches (6 to 24 on a 6 x 8 map, so
    most taps fall in the padding) and their sum; K+1 outputs with
    mask_softmax."""
    jh, params, th, feats = _aspp_pair(16, mask_softmax=mask_softmax)
    want = np.moveaxis(np.asarray(jh.apply({"params": params}, jnp.asarray(feats))), -1, 0)
    with torch.no_grad():
        got = th(torch.from_numpy(feats)).numpy()
    assert got.shape == (K + mask_softmax, 6, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_aspp_init_is_he_normal():
    """The port's own init: he_normal (fan_in, truncated at 2 std), zero
    biases, named as the flax tree."""
    torch.manual_seed(0)
    th = aspp.ASPPHead(64, K, (32, 32))
    names = {n for n, _ in th.named_parameters()}
    assert {f"dilation{d}.{c}.{w}" for d in (6, 12, 18, 24)
            for c in ("conv1", "conv2", "predictor") for w in ("weight", "bias")} == names
    w = th.dilation12.conv1.weight.detach()
    std = np.sqrt(2.0 / (64 * 9))
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert th.dilation6.conv1.dilation == (6, 6) and th.dilation6.conv1.padding == (6, 6)
    assert not any(m.bias.any() for m in th.modules() if isinstance(m, torch.nn.Conv2d))


@pytest.mark.parametrize("src,dst", [((6, 8), (48, 64)), ((6, 8), (96, 128)),
                                     ((6, 8), (45, 61)), ((11, 7), (48, 30))])
def test_resize_bilinear_matches_jax(src, dst):
    """x8 and x16 (the stride-8 map to the canvas and beyond) and two
    non-integer factors, one of them mixed."""
    x = np.random.RandomState(1).uniform(-3, 3, (K,) + src).astype(np.float32)
    want = np.asarray(jax_aspp.resize_bilinear(jnp.asarray(np.moveaxis(x, 0, -1)), dst))
    got = aspp.resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 0), rtol=1e-5, atol=2e-6)


def _cpgs(seed, hw=(20, 24)):
    """CPG-like maps with cells in each band: >= 0.1, [0.005, 0.1), < 0.005."""
    rng = np.random.RandomState(seed)
    bands = rng.choice([0.0, 0.003, 0.05, 0.1, 0.3, 1.0], (K,) + hw)
    return (bands * rng.uniform(0.9, 1.0, (K,) + hw)).astype(np.float32)


@pytest.mark.parametrize("preds,gt", [([0.9, 0.2, 0.9], [1, 1, 0]),
                                      ([0.7, 0.95, 0.1], [1, 0, 1]),
                                      ([0.3, 0.3, 0.3], [0, 0, 0])])
def test_seg_targets_from_cpg_match_jax_exactly(preds, gt):
    """A class below tau ignored over its CPG labels, an absent class
    negative everywhere, the rest by the fg / bg bands; 1/#pos and 1/#neg."""
    cpgs = _cpgs(2)
    gt = np.asarray(gt, np.float32)
    preds = np.asarray(preds, np.float32)
    jt, jw = jax_aspp.seg_targets_from_cpg(jnp.asarray(cpgs), jnp.asarray(gt), jnp.asarray(preds))
    tt, tw = aspp.seg_targets_from_cpg(torch.from_numpy(cpgs), torch.from_numpy(gt),
                                       torch.from_numpy(preds))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tt.dtype == tw.dtype == torch.float32


def test_sem_seg_and_constraint_losses_match_jax():
    """The BCE with a NaN logit zeroed and loss_weight 2; the KL with
    entries above 1000 zeroed, and its gradient; the port's maps are (K, H,
    W), the JAX loss's (H, W, K)."""
    rng = np.random.RandomState(3)
    z = rng.normal(0, 4, (K, 20, 24)).astype(np.float32)
    z[1, 3, 4] = np.nan
    t, w = aspp.seg_targets_from_cpg(torch.from_numpy(_cpgs(4)), torch.tensor([1.0, 1, 0]),
                                     torch.tensor([0.9, 0.8, 0.9]))
    hwk = lambda a: jnp.asarray(np.moveaxis(_np(a), 0, -1))     # noqa: E731
    want = float(jax_aspp.sem_seg_loss(hwk(z), hwk(t), hwk(w), 2.0))
    got = float(aspp.sem_seg_loss(torch.from_numpy(z), t, w, 2.0))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)

    x = rng.uniform(0, 1, (K, 20, 24)).astype(np.float32)
    p = rng.uniform(0, 1, (K, 20, 24)).astype(np.float32)
    p[0, 0, :5] = 0.0
    wc = rng.uniform(0, 1, (K, 20, 24)).astype(np.float32)
    wc[2, 5, :6] = 1e5          # entries above 1000: zeroed
    want, jgrad = jax.value_and_grad(jax_aspp.constraint_loss)(
        jnp.asarray(x), jnp.asarray(p), jnp.asarray(wc))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = aspp.constraint_loss(xt, torch.from_numpy(p), torch.from_numpy(wc))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-9)


def _probs(c, hw, seed):
    p = np.random.RandomState(seed).uniform(0, 1, (c,) + hw).astype(np.float32) ** 3
    return p / p.sum(axis=0, keepdims=True)


@pytest.mark.parametrize("labels,image", [(3, "uint8"), (21, "uint8"), (3, "float"),
                                          (21, "float"), (3, "uint8_other_size"),
                                          (21, "float_other_size")])
def test_dense_crf_bit_identical_to_jax(labels, image):
    """3 and 21 labels; the guide image uint8 or float (BGR minus the means,
    clipped after adding them back), at the probabilities' size or another
    (the nearest index maps)."""
    hw = (36, 52)
    rng = np.random.RandomState(labels)
    img_hw = (23, 70) if image.endswith("other_size") else hw
    if image.startswith("uint8"):
        img = rng.randint(0, 256, (3,) + img_hw).astype(np.uint8)
    else:
        img = rng.uniform(-140, 160, (3,) + img_hw).astype(np.float32)
    probs = _probs(labels, hw, labels + 7)
    want = jax_crf.dense_crf(probs, img)
    got = port_crf.dense_crf(probs, img)
    assert got.shape == (labels,) + hw and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, probs)
    if labels == 3:     # other parameters than the defaults
        kw = dict(max_iter=3, size_std=200.0, bi_w=5.0, bi_r_std=7.0)
        np.testing.assert_array_equal(port_crf.dense_crf(probs, img, **kw),
                                      jax_crf.dense_crf(probs, img, **kw))


@pytest.mark.parametrize("d,c", [(2, 1), (5, 3), (5, 21)])
def test_grid_filter_bit_identical_to_jax(d, c):
    rng = np.random.RandomState(d * 10 + c)
    feats = (rng.rand(300, d) * 5).astype(np.float32)
    vals = rng.rand(300, c).astype(np.float32)
    np.testing.assert_array_equal(port_crf.grid_filter(feats, vals),
                                  jax_crf.grid_filter(feats, vals))


def test_dense_crf_source_is_a_copy_and_builds_into_build(tmp_path, monkeypatch):
    """The port's C++ source is the JAX package's byte for byte; its library
    lives under build/sos_wsod_torch/ named by a digest of the source and
    the flags (the JAX binding's); without g++ the build raises and writes
    nothing."""
    ours = (ROOT / "sos_wsod_torch" / "native" / "dense_crf.cpp").read_bytes()
    assert ours == (ROOT / "sos_wsod_tpu" / "native" / "dense_crf.cpp").read_bytes()
    assert build.HOST_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")
    lib = build.build_host("dense_crf")
    assert lib.parent == ROOT / "build" / "sos_wsod_torch" and lib.is_file()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build_host("dense_crf")
    assert not (tmp_path / "build").exists()


def test_crf_constraint_matches_jax_exactly():
    """The host round trip: [1 - max fg; fg] on the raw image clipped to
    uint8 (pixels beyond 0..255 included), the CRF, and the 0.5 threshold's
    balancing weights, as the JAX callback computes them."""
    rng = np.random.RandomState(5)
    image = rng.uniform(-20, 280, (30, 40, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (K, 30, 40)).astype(np.float32) ** 2
    want = jax_aspp.crf_constraint(jnp.asarray(image), jnp.asarray(x))
    got = aspp.crf_constraint(torch.from_numpy(image), torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] >= 0.5).any() and (got[0] < 0.5).any()


# ---------------------------------------------------------------- the head
P, CH, IMHW, FHW = 24, 16, (48, 64), (6, 8)


def _head_inputs(seed):
    rng = np.random.RandomState(seed)
    pooled = rng.uniform(0, 1, (P, 7, 7, CH)).astype(np.float32)
    pts = rng.uniform(0, 1, (P, 2)) * (np.array(IMHW[::-1]) - 14)
    wh = rng.uniform(4, 20, (P, 2))
    return {"pooled": pooled,
            "boxes": np.concatenate([pts, pts + wh], 1).astype(np.float32),
            "objectness": rng.uniform(0, 1, P).astype(np.float32),
            "valid": np.arange(P) < P - 4,
            "gt": np.array([1, 0, 1], np.float32),
            "cpgs": (rng.uniform(0, 1, (K,) + IMHW) ** 3).astype(np.float32),
            "feats": rng.uniform(0, 1, FHW + (CH,)).astype(np.float32),
            "image": rng.uniform(0, 255, IMHW + (3,)).astype(np.float32)}


def _head_pair(constraint, inputs, tau=0.0):
    jh = jax_wsjds.WSJDSROIHead(num_classes=K, dan_dims=(32, 32), aspp_dims=(8, 8), tau=tau,
                                constraint=constraint)
    a = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jh.init(jax.random.PRNGKey(0), a["pooled"], a["boxes"], a["objectness"],
                     a["valid"], a["gt"], a["cpgs"], a["feats"], a["image"], jnp.asarray(True),
                     method=jh.losses)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(9)
    for branch in params["sem_seg_head"].values():
        for conv in branch.values():
            conv["bias"] = rng.normal(0, 0.1, conv["bias"].shape).astype(np.float32)
    th = wsjds.WSJDSROIHead(7 * 7 * CH, CH, K, tau=tau, constraint=constraint,
                            dan_dims=(32, 32), dan_dropout=0.0, aspp_dims=(8, 8),
                            aspp_dropout=0.0, device="meta")
    th.to_empty(device="cpu")
    th.load_state_dict(state_dict_from_flax(params), strict=True)
    return jh, params, th


def _port_inputs(inputs):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inputs.items()}
    # the port's pooler fuses the objectness weighting the JAX head applies
    t["pooled"] = torch.from_numpy(inputs["pooled"] * (inputs["objectness"] + np.float32(1.0))
                                   [:, None, None, None])
    return t


@pytest.mark.parametrize("constraint,use_csc", [(False, True), (True, True), (False, False)])
def test_wsjds_head_losses_and_gradients_match_jax(constraint, use_csc):
    """Every loss term and every parameter gradient: the CSC losses on the
    CPG maps, loss_sem_seg on their targets (tau 0, so present classes
    keep their labels), loss_constraint through the host CRF, and the
    mask_ CSC losses x 0.1 on the peak-normalised masks; past CSC_MAX_ITER
    (use_csc False) loss_sem_seg and loss_constraint are 0, the ASPP's
    gradients exact zeros (not none), and the mask_ terms 0.1 x the plain
    MIL terms."""
    inputs = _head_inputs(11)
    jh, params, th = _head_pair(constraint, inputs)
    a = {k: jnp.asarray(v) for k, v in inputs.items()}

    def total(p):
        losses = jh.apply({"params": p}, a["pooled"], a["boxes"], a["objectness"], a["valid"],
                          a["gt"], a["cpgs"], a["feats"], a["image"], jnp.asarray(use_csc),
                          method=jh.losses)
        return sum(losses.values()), losses

    (_, want), grads = jax.value_and_grad(total, has_aux=True)(params)
    t = _port_inputs(inputs)
    losses = th.train().losses(t["pooled"], t["boxes"], t["valid"], t["gt"], t["cpgs"],
                               t["feats"], t["image"], use_csc)
    sum(losses.values()).backward()
    keys = {"loss_cls_pos", "loss_cls_neg", "loss_sem_seg", "mask_loss_cls_pos",
            "mask_loss_cls_neg"} | ({"loss_constraint"} if constraint else set())
    assert set(losses) == set(want) == keys
    for k in sorted(keys):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    if use_csc:
        assert losses["loss_sem_seg"].item() > 0
    else:
        assert losses["loss_sem_seg"].item() == 0.0
        np.testing.assert_allclose(losses["mask_loss_cls_pos"].item(),
                                   0.1 * losses["loss_cls_pos"].item(), rtol=1e-6)
    named = dict(th.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(named)
    for path, g in flat:
        keys_ = [str(k.key) for k in path]
        name = ".".join(keys_[:-1] + ["weight" if keys_[-1] == "kernel" else "bias"])
        g = np.asarray(g)
        p = named[name]
        assert p.grad is not None, name
        if name.startswith("sem_seg_head") and not use_csc:
            assert not p.grad.any() and not g.any(), name
        np.testing.assert_allclose(_flax_grad(name, p.grad), g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=name)
    assert any(named[n].grad.any() for n in named if n.startswith("sem_seg_head")) == use_csc


def test_wsjds_head_predict_and_crop_match_jax():
    """predict's scores (a zero background column), boxes and masks in [0,
    1] at the canvas; crop_instance_masks with boxes whose coordinates are
    fractional or negative (truncated toward zero), exact on the same
    masks."""
    inputs = _head_inputs(12)
    jh, params, th = _head_pair(False, inputs)
    a = {k: jnp.asarray(v) for k, v in inputs.items()}
    js, jb, jmasks = jh.apply({"params": params}, a["pooled"], a["boxes"], a["objectness"],
                              a["valid"], a["feats"], IMHW, method=jh.predict)
    t = _port_inputs(inputs)
    with torch.no_grad():
        th.eval()
        scores, boxes = th.predict(t["pooled"], t["boxes"], t["valid"])
        masks = th.predict_masks(t["feats"], IMHW)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    assert masks.shape == (K,) + IMHW and masks.dtype == torch.float32
    assert float(masks.min()) >= 0 and float(masks.max()) <= 1
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), rtol=1e-5, atol=2e-6)

    det_boxes = np.array([[2.7, 3.2, 10.9, 20.5], [-0.6, -1.5, 64.0, 48.0],
                          [30.0, 40.0, 29.0, 41.0], [0.0, 0.0, 0.99, 47.2]], np.float32)
    det_classes = np.array([0, 2, 1, 2], np.int32)
    want = np.asarray(jax_wsjds.crop_instance_masks(jmasks, jnp.asarray(det_boxes),
                                                    jnp.asarray(det_classes)))
    got = wsjds.crop_instance_masks(torch.from_numpy(np.array(jmasks)),
                                    torch.from_numpy(det_boxes), torch.from_numpy(det_classes))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, :3].eq(0).all() and got[0, 3:20, 2:10].ne(0).all() and not got[2].any()


def test_aspp_dropout_draws_from_the_generator():
    """Training-mode dropout in the ASPP draws from the caller's generator:
    the same seed gives the same logits, another seed others; eval mode
    draws nothing."""
    th = aspp.ASPPHead(CH, K, (8, 8))
    feats = torch.from_numpy(_head_inputs(1)["feats"])

    def run(seed):
        return th.train()(feats, torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    th.eval()(feats, gen)
    assert torch.equal(gen.get_state(), state)
    assert functools.reduce(lambda n, m: n + isinstance(m, torch.nn.Conv2d), th.modules(), 0) == 12
