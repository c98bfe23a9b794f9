"""The port's CascadeROIHeads (sos_wsod_torch/models/roi_heads/mask_cascade.py)
against the JAX package's, on the CPU in f32: each stage's losses with JAX's
stage-0 sampling draws fed in (1e-5), the gradients of all three stages and
of the features (1e-4), and predict_scores_boxes (1e-5). The scene, the
fixed 2 x 2 pooler grid and the tolerances' form are those of
tests/test_torch_mask_cascade.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.roi_heads import mask_cascade as jmc
from sos_wsod_torch.core import sampling
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.models.roi_heads import mask_cascade as mc
from test_torch_frcnn_train import JaxDraws
from test_torch_mask_cascade import (  # noqa: F401 (fixtures)
    C, G, IMAGE, K, P, _close, _random_params, _torch_features, fixed_grid, scene)


@pytest.fixture(scope="module")
def cascade_setup(scene):
    rng = np.random.default_rng(5)
    jhead = jmc.CascadeROIHeads(num_classes=K, batch_size_per_image=16, fc_dim=32)
    jf = {k: jnp.asarray(v) for k, v in scene["feats"].items()}
    args = [jnp.asarray(scene[k]) for k in ("props", "prop_logits", "prop_valid", "gt_boxes",
                                           "gt_classes", "gt_valid")]
    params = _random_params(jhead, rng, jf, *args, jax.random.PRNGKey(0),
                            jnp.asarray([IMAGE, IMAGE], jnp.int32), method=jhead.losses)
    port = mc.CascadeROIHeads(in_channels=C, num_classes=K, batch_size_per_image=16, fc_dim=32)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return jhead, params, port


def _stage0_draws(key, n=P + G):
    k_pos, k_neg = jax.random.split(key)
    return [np.asarray(jax.random.uniform(k, (n,))) for k in (k_pos, k_neg, key)]


def test_cascade_losses_and_gradients_match_jax(scene, cascade_setup, monkeypatch):
    jhead, params, port = cascade_setup
    key = jax.random.PRNGKey(7)
    hw = jnp.asarray([IMAGE, IMAGE], jnp.int32)
    jf = {k: jnp.asarray(v) for k, v in scene["feats"].items()}
    args = [jnp.asarray(scene[k]) for k in ("props", "prop_logits", "prop_valid", "gt_boxes",
                                           "gt_classes", "gt_valid")]

    def total(p, feats):
        losses = jhead.apply({"params": p}, feats, *args, key, hw, method=jhead.losses)
        return sum(losses.values()), losses

    (_, want), (g_p, g_f) = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(params, jf)
    draws = JaxDraws(_stage0_draws(key))
    monkeypatch.setattr(sampling, "uniform", draws)
    tf = _torch_features(scene["feats"], grad=True)
    got = port.losses(tf, *(torch.from_numpy(scene[k]) for k in (
        "props", "prop_logits", "prop_valid", "gt_boxes", "gt_classes", "gt_valid")),
        torch.Generator(), torch.tensor([IMAGE, IMAGE]))
    assert not draws.arrays
    assert set(got) == set(want) == {f"{n}_stage{k}" for n in ("loss_cls", "loss_box_reg")
                                     for k in range(3)}
    for k in sorted(want):
        _close(got[k].item(), want[k], 1e-5, k)
        assert float(want[k]) > 0, k
    sum(got.values()).backward()
    n = 0
    for name, p in port.named_parameters():
        head, layer, leaf = name.split(".")
        g = np.asarray(g_p[head][layer]["kernel" if leaf == "weight" else leaf])
        _close(p.grad.numpy().T if leaf == "weight" else p.grad.numpy(), g, 1e-4, name)
        assert np.abs(g).max() > 0, name
        n += 1
    assert n == 3 * 8
    for k in scene["feats"]:
        _close(tf[k].grad.numpy(), g_f[k], 1e-4, k)


def test_cascade_predict_scores_boxes_matches_jax(scene, cascade_setup):
    jhead, params, port = cascade_setup
    jf = {k: jnp.asarray(v) for k, v in scene["feats"].items()}
    want_s, want_b = jhead.apply({"params": params}, jf, jnp.asarray(scene["props"]),
                                 jnp.asarray(scene["prop_valid"]),
                                 jnp.asarray([IMAGE, IMAGE], jnp.int32),
                                 method=jhead.predict_scores_boxes)
    with torch.no_grad():
        got_s, got_b = port.predict_scores_boxes(
            _torch_features(scene["feats"]), torch.from_numpy(scene["props"]),
            torch.from_numpy(scene["prop_valid"]), torch.tensor([IMAGE, IMAGE]))
    assert got_s.shape == (P, K + 1) and got_b.shape == (P, 4)
    _close(got_s.numpy(), want_s, 1e-5, "scores")
    _close(got_b.numpy(), want_b, 1e-5, "boxes")
    assert float(got_b.max()) <= IMAGE and float(got_b.min()) >= 0
