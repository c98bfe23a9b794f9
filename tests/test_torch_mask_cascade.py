"""The port's mask head and cascade ROI heads
(sos_wsod_torch/models/roi_heads/mask_cascade.py) against the JAX package's
(sos_wsod_tpu/models/roi_heads/mask_cascade.py), on the CPU in f32 (the
cascade's tests in tests/test_torch_cascade.py, on this file's scene), with the
JAX side run eagerly (no jit) at a small size: FPN levels p2-p5 of a 128 x
128 image with 16 channels, 24 proposals, 3 ground-truth boxes, 3 classes.

The heads pool with a fixed 2 x 2 sample grid here (both packages'
``multilevel_roi_align`` wrapped by the module's ``fixed_grid`` fixture):
the adaptive grid's 8 x 8 samples cost 16x the eager JAX ops, and the
pooler itself is held against JAX in tests/test_torch_roi_align_grad.py and
tests/test_torch_frcnn.py. ``crop_gt_masks`` keeps its adaptive grid.

The JAX parameter trees (biases drawn at random so that they matter) are
carried across by ``engine/weights.py:state_dict_from_flax`` and loaded
strictly. The mask head's 2x2 transposed conv has a random, so asymmetric,
kernel: flax's ConvTranspose does not flip its kernel and torch's
ConvTranspose2d does, so the bridge flips it (an unflipped kernel is checked
to give other logits). The cascade's stage-0 sampling draws are JAX's, in the
JAX order, fed through ``core/sampling.py:uniform``.

Tolerances: mask head logits and MaskROIHeads.predict 1e-5; mask_rcnn_loss
1e-6; MaskROIHeads' loss and gradients (parameters and features) 1e-4;
each cascade stage's losses 1e-5, the gradients of all three stages and of
the features 1e-4 (rtol, and atol that fraction of the largest entry);
predict_scores_boxes 1e-5. The GT mask targets must be equal, except bins
whose pooled value lies within 1e-6 of the 0.5 threshold, which the test
names: the port pools every box once over a map whose channels are the G
masks (kernel D's layout), the JAX package each sample's matched mask.

Also the detectron2 bridge: ``state_dict_from_d2_frcnn`` maps d2's cascade
keys (``box_head.k``, ``box_predictor.k``) and mask-head keys, takes d2's
deconv as it is (torch's layout already; the JAX bridge, which transposes it
without the flip, parts from the port there by design), and the result
loads strictly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.roi_heads import mask_cascade as jmc
from sos_wsod_torch.engine.weights import _fc1_channels_last, state_dict_from_d2_frcnn, state_dict_from_flax
from sos_wsod_torch.models.roi_heads import mask_cascade as mc
from sos_wsod_torch.ops.roi_align import roi_align

K, C, G, P = 3, 16, 3, 24
IMAGE = 128


def _fixed_grid(fn):
    def pool(*args, **kw):
        return fn(*args, **{**kw, "sampling_ratio": 2})
    return pool


@pytest.fixture(scope="module", autouse=True)
def fixed_grid():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmc, "multilevel_roi_align", _fixed_grid(jmc.multilevel_roi_align))
        mp.setattr(mc, "multilevel_roi_align", _fixed_grid(mc.multilevel_roi_align))
        yield


def _close(got, want, rtol, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def _features(rng):
    return {name: rng.normal(size=(IMAGE // s, IMAGE // s, C)).astype(np.float32)
            for name, s in zip(("p2", "p3", "p4", "p5"), (4, 8, 16, 32))}


def _torch_features(feats, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in feats.items()}


def _random_biases(params, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0, 0.1, v.shape).astype(np.float32)
                         if path[-1].key == "bias" else np.asarray(v, np.float32)), params)


def _random_params(module, rng, *args, **kw):
    """A parameter tree of ``module`` drawn at random from its shapes
    (``jax.eval_shape``: no eager init pass): kernels normal over
    sqrt(fan-in), biases normal 0.1."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]

    def draw(path, v):
        if path[-1].key == "bias":
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        fan_in = int(np.prod(v.shape[:-1])) if len(v.shape) != 4 or path[-2].key != "deconv" \
            else v.shape[2]
        return (rng.normal(size=v.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _ellipses(rng, boxes, hw):
    """A filled ellipse inside each box, (G, H, W) f32."""
    yy, xx = np.mgrid[:hw[0], :hw[1]] + 0.5
    out = []
    for x1, y1, x2, y2 in boxes:
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        out.append((((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1).astype(np.float32))
    return np.stack(out)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    gxy = rng.uniform(0, 70, (G, 2))
    gt_boxes = np.concatenate([gxy, gxy + rng.uniform(20, 50, (G, 2))], 1).astype(np.float32)
    jit = rng.normal(0, 3, (P // 2, 4)).astype(np.float32)
    props = np.concatenate([gt_boxes[rng.integers(0, G, P // 2)] + jit,
                            np.concatenate(
                                [xy := rng.uniform(0, 90, (P // 2, 2)),
                                 xy + rng.uniform(8, 40, (P // 2, 2))], 1)]).astype(np.float32)
    return {"feats": _features(rng), "gt_boxes": gt_boxes,
            "gt_classes": np.array([0, 2, 1], np.int32), "gt_valid": np.array([True, True, False]),
            "gt_masks": _ellipses(rng, gt_boxes, (IMAGE, IMAGE)), "props": props,
            "prop_logits": rng.normal(size=P).astype(np.float32),
            "prop_valid": np.arange(P) < P - 3, "rng": rng}


# ------------------------------------------------------------ mask head
def test_mask_head_logits_match_jax_with_the_deconv_flip():
    rng = np.random.default_rng(1)
    head = jmc.MaskRCNNConvUpsampleHead(num_classes=5, num_conv=2, conv_dim=8)
    x = rng.normal(size=(6, 14, 14, C)).astype(np.float32)
    params = _random_biases(head.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    k = np.asarray(params["deconv"]["kernel"])
    assert not np.allclose(k, k[::-1, ::-1])                      # asymmetric
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x)))
    port = mc.MaskRCNNConvUpsampleHead(C, num_classes=5, num_conv=2, conv_dim=8)
    sd = state_dict_from_flax(params)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (6, 5, 28, 28)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    # without the flip the transposed conv computes something else
    port.deconv.weight.data = torch.from_numpy(k.transpose(2, 3, 0, 1).copy())
    with torch.no_grad():
        unflipped = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1)
    assert np.abs(unflipped.numpy() - want).max() > 1e-3


def test_crop_gt_masks_matches_jax(scene):
    rng = np.random.default_rng(2)
    s = 20
    xy = rng.uniform(-10, 110, (s, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 80, (s, 2))], 1).astype(np.float32)
    boxes[:G] = scene["gt_boxes"]
    boxes[G] = [0, 0, IMAGE, IMAGE]
    masks = np.concatenate([scene["gt_masks"], rng.uniform(size=(2, IMAGE, IMAGE)) > 0.5])
    matched = rng.integers(0, len(masks), s).astype(np.int32)
    matched[:G] = np.arange(G)
    want = np.asarray(jmc.crop_gt_masks(jnp.asarray(masks, jnp.float32), jnp.asarray(boxes),
                                        jnp.asarray(matched), 28))
    got = mc.crop_gt_masks(torch.from_numpy(masks.astype(np.float32)), torch.from_numpy(boxes),
                           torch.from_numpy(matched), 28).numpy()
    assert got.shape == (s, 28, 28) and got.dtype == np.float32
    assert got[:G].mean() > 0.4 and 0 < got.mean() < 1
    # the bins within 1e-6 of the threshold, from the pooled values
    pooled = roi_align(torch.from_numpy(masks.transpose(1, 2, 0).astype(np.float32)),
                       torch.from_numpy(boxes), torch.ones(s, dtype=torch.bool), spatial_scale=1.0,
                       output_size=(28, 28), sampling_ratio=0, aligned=True).numpy()
    pooled = pooled[np.arange(s), matched]
    near = np.abs(pooled - 0.5) <= 1e-6
    diff = got != want
    assert not (diff & ~near).any(), f"targets differ at {np.argwhere(diff & ~near)[:10]}"
    assert diff.sum() <= near.sum(), np.argwhere(near)


@pytest.mark.parametrize("agnostic", [False, True])
def test_mask_rcnn_loss_matches_jax(agnostic):
    rng = np.random.default_rng(3)
    s, r, k = 10, 8, 1 if agnostic else 4
    logits = (rng.normal(size=(s, r, r, k)) * 4).astype(np.float32)
    targets = (rng.uniform(size=(s, r, r)) > 0.5).astype(np.float32)
    cls = rng.integers(0, 5, s).astype(np.int32)      # 4 clipped to K - 1
    fg = rng.uniform(size=s) > 0.4
    want = float(jmc.mask_rcnn_loss(jnp.asarray(logits), jnp.asarray(cls), jnp.asarray(fg),
                                    jnp.asarray(targets), agnostic))
    got = mc.mask_rcnn_loss(torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
                            torch.from_numpy(cls), torch.from_numpy(fg),
                            torch.from_numpy(targets), agnostic)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    none = mc.mask_rcnn_loss(torch.zeros(2, k, r, r), torch.zeros(2), torch.zeros(2, dtype=torch.bool),
                             torch.zeros(2, r, r), agnostic)
    assert none.item() == 0.0


@pytest.fixture(scope="module")
def mask_setup(scene):
    rng = np.random.default_rng(4)
    s = 12
    boxes = np.concatenate([scene["gt_boxes"][rng.integers(0, G, s)]
                            + rng.normal(0, 4, (s, 4))]).astype(np.float32)
    args = dict(boxes=boxes, valid=np.arange(s) < s - 2,
                gt_classes=rng.integers(0, K, s).astype(np.int32),
                fg=np.arange(s) < 8, matched=rng.integers(0, G, s).astype(np.int32))
    jhead = jmc.MaskROIHeads(num_classes=K, num_conv=2, conv_dim=8, pooler_resolution=14)
    jf = {k: jnp.asarray(v) for k, v in scene["feats"].items()}
    jargs = [jnp.asarray(args[k]) for k in ("boxes", "valid", "gt_classes", "fg")]
    params = _random_params(jhead, rng, jf, *jargs, jnp.asarray(scene["gt_masks"]),
                            jnp.asarray(args["matched"]), method=jhead.losses)
    port = mc.MaskROIHeads(in_channels=C, num_classes=K, num_conv=2, conv_dim=8,
                           pooler_resolution=14)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return jhead, params, port, args


def test_mask_roi_heads_loss_and_gradients_match_jax(scene, mask_setup):
    jhead, params, port, a = mask_setup
    jf = {k: jnp.asarray(v) for k, v in scene["feats"].items()}

    def loss(p, feats):
        return jhead.apply({"params": p}, feats, jnp.asarray(a["boxes"]), jnp.asarray(a["valid"]),
                           jnp.asarray(a["gt_classes"]), jnp.asarray(a["fg"]),
                           jnp.asarray(scene["gt_masks"]), jnp.asarray(a["matched"]),
                           method=jhead.losses)["loss_mask"]

    want, (g_p, g_f) = jax.value_and_grad(loss, argnums=(0, 1))(params, jf)
    tf = _torch_features(scene["feats"], grad=True)
    got = port.losses(tf, torch.from_numpy(a["boxes"]), torch.from_numpy(a["valid"]),
                      torch.from_numpy(a["gt_classes"]), torch.from_numpy(a["fg"]),
                      torch.from_numpy(scene["gt_masks"]), torch.from_numpy(a["matched"]))
    assert set(got) == {"loss_mask"} and float(want) > 0.1
    got["loss_mask"].backward()
    _close(got["loss_mask"].item(), want, 1e-4)
    for name, p in port.named_parameters():
        *path, leaf = name.split(".")
        g = g_p
        for k in path:
            g = g[k]
        g = np.asarray(g["kernel" if leaf == "weight" else leaf])
        t = p.grad.numpy()
        if leaf == "weight" and t.ndim == 4:
            t = (t.transpose(2, 3, 0, 1)[::-1, ::-1] if path[-1] == "deconv"
                 else t.transpose(2, 3, 1, 0))
        _close(t, g, 1e-4, name)
    for k in scene["feats"]:
        _close(tf[k].grad.numpy(), g_f[k], 1e-4, k)


def test_mask_roi_heads_predict_matches_jax(scene, mask_setup):
    jhead, params, port, a = mask_setup
    jf = {k: jnp.asarray(v) for k, v in scene["feats"].items()}
    want = jhead.apply({"params": params}, jf, jnp.asarray(a["boxes"]), jnp.asarray(a["valid"]),
                       jnp.asarray(a["gt_classes"]), method=jhead.predict)
    with torch.no_grad():
        got = port.predict(_torch_features(scene["feats"]), torch.from_numpy(a["boxes"]),
                           torch.from_numpy(a["valid"]), torch.from_numpy(a["gt_classes"]))
    assert got.shape == (12, 28, 28) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)


# ------------------------------------------------------------ the d2 bridge
def test_d2_bridge_maps_cascade_and_mask_keys():
    """A d2-layout state dict (fc1 inputs in (c, h, w) order, deconv in
    torch's layout) -> the port's names; it loads strictly into the heads."""
    torch.manual_seed(0)
    cascade = mc.CascadeROIHeads(in_channels=C, num_classes=K, fc_dim=32)
    mask = mc.MaskROIHeads(in_channels=C, num_classes=K, num_conv=2, conv_dim=8)
    d2 = {}
    for name, v in cascade.state_dict().items():
        head, layer, leaf = name.split(".")
        base, k = head.rsplit("_", 1)
        a = v.numpy()
        if layer == "fc1" and leaf == "weight":   # d2 flattens NCHW ROIs
            a = a.reshape(32, 7, 7, C).transpose(0, 3, 1, 2).reshape(32, -1)
        d2[f"roi_heads.{base}.{k}.{layer}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(a))
    for name, v in mask.state_dict().items():
        d2[f"roi_heads.{name}"] = v.clone()
    d2["pixel_mean"] = torch.zeros(3)
    sd = state_dict_from_d2_frcnn(d2)
    assert set(sd) == {f"roi_heads.{k}" for k in cascade.state_dict()} | \
        {f"roi_heads.{k}" for k in mask.state_dict()}
    for name, v in cascade.state_dict().items():
        assert torch.equal(sd[f"roi_heads.{name}"], v), name
    assert torch.equal(sd["roi_heads.mask_head.deconv.weight"], mask.mask_head.deconv.weight)
    w = d2["roi_heads.box_head.1.fc1.weight"].numpy()
    assert np.array_equal(sd["roi_heads.box_head_1.fc1.weight"].numpy(), _fc1_channels_last(w))
    strip = {k[len("roi_heads."):]: v for k, v in sd.items()}
    cascade.load_state_dict({k: v for k, v in strip.items() if k.startswith("box_")}, strict=True)
    mask.load_state_dict({k: v for k, v in strip.items() if k.startswith("mask_")}, strict=True)
