"""The port's WS-ResNet (sos_wsod_torch/models/backbones/resnet_ws.py)
against the JAX package's (sos_wsod_tpu/models/backbones/resnet_ws.py) on
the CPU in float32: the stem, a block with a shortcut and a trailing pool at
stride 2 and at stride 1 (the edge pad), one without either, and the whole
trunk at depth 14 (the JAX tests' mini depth) with res5_dilation 2 and 1, the
weights carried from the JAX tree by ``state_dict_from_flax`` with no new
mapping; the trunk's gradients with freeze_at 0 and 2; ``build_ws_resnet``
reading the config as the JAX `build_ws_resnet` does; and the stride-8 and stride-16
shapes that tests/test_backbones_ws.py asserts.

Inputs are small (narrow widths: stem 8, res2 16, 4 channels a group), the
FrozenBN statistics random (the JAX init is the identity). Tolerances (two
f32 implementations that sum their convolutions in different orders):
outputs within rtol 1e-4 and an atol of 1e-5 of the output's largest entry;
gradients within rtol 1e-4 and 1e-5 of the leaf's largest entry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.backbones import resnet_ws as jax_ws
from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.models.backbones.resnet_ws import (
    WSBasicStem, WSBottleneckBlock, WSResNet, build_ws_resnet)

WIDTHS = dict(stem_out_channels=8, res2_out_channels=16, width_per_group=4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_stats(params, seed):
    """The JAX init with FrozenBN statistics drawn at random."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))

    def walk(node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value)
            elif key in ("weight", "running_var"):
                node[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
            elif key in ("bias", "running_mean"):
                node[key] = rng.normal(0, 0.2, value.shape).astype(np.float32)

    walk(params)
    return params


def _pair(jax_module, port_module, shape, seed):
    """The JAX module's init on an (N, H, W, C) input, with random
    statistics, loaded strictly into the port module; returns (params, the
    port module, the input)."""
    x = np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)
    params = _random_stats(jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"],
                           seed)
    port_module.load_state_dict(state_dict_from_flax(params), strict=True)
    return params, port_module, x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def test_stem_matches_jax():
    params, port, x = _pair(jax_ws.WSBasicStem(8), WSBasicStem(3, 8), (2, 30, 34, 3), 0)
    want = jax_ws.WSBasicStem(8).apply({"params": params}, jnp.asarray(x))
    _close(port(_nchw(x)), want)
    assert want.shape == (2, 7, 8, 8)


@pytest.mark.parametrize("cin,cout,pool_stride,dilation", [
    (8, 16, 2, 1), (8, 16, 1, 1), (16, 16, 0, 2), (16, 16, 1, 2)])
def test_block_matches_jax(cin, cout, pool_stride, dilation):
    """A shortcut where the widths differ; the trailing pool at stride 2, at
    stride 1 after the edge pad (the size kept), or none."""
    jm = jax_ws.WSBottleneckBlock(in_channels=cin, out_channels=cout, bottleneck_channels=4,
                                  dilation=dilation, has_pool=pool_stride > 0,
                                  pool_stride=max(pool_stride, 1))
    pm = WSBottleneckBlock(cin, cout, 4, dilation=dilation, pool_stride=pool_stride)
    params, pm, x = _pair(jm, pm, (1, 11, 13, cin), 1)
    want = jm.apply({"params": params}, jnp.asarray(x))
    _close(pm(_nchw(x)), want)
    assert ("shortcut" in params) == (cin != cout) == pm.has_shortcut
    assert want.shape[1:3] == ((5, 6) if pool_stride == 2 else (11, 13))


@pytest.mark.parametrize("res5_dilation", [2, 1])
def test_trunk_and_its_gradients_match_jax(res5_dilation):
    """Depth 14, every stage's output and their strides (8 or 16); the
    gradients of every conv weight with freeze_at 0; with freeze_at 2 the
    stem and res2 take none (their parameters do not require grad, where
    the JAX gradient is zero) and the rest agree; FrozenBN's statistics
    are buffers (their JAX gradient is zero)."""
    feats = ("res2", "res3", "res4", "res5")
    jm = jax_ws.WSResNet(depth=14, res5_dilation=res5_dilation, freeze_at=0, out_features=feats,
                         **WIDTHS)
    pm = WSResNet(depth=14, res5_dilation=res5_dilation, freeze_at=0, out_features=feats,
                  **WIDTHS)
    params, pm, x = _pair(jm, pm, (1, 64, 48, 3), 2)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = pm(_nchw(x))
    stride = 8 if res5_dilation == 2 else 16
    for name in feats:
        _close(got[name], want[name], name)
    assert got["res5"].shape[2:] == (64 // stride, 48 // stride) and pm.stride == stride
    assert got["res5"].shape[1] == pm.out_channels == 128

    ct = np.random.RandomState(3).normal(0, 1, want["res5"].shape).astype(np.float32)
    for freeze_at in (0, 2):
        jf = jax_ws.WSResNet(depth=14, res5_dilation=res5_dilation, freeze_at=freeze_at,
                             **WIDTHS)
        grads = jax.grad(lambda p: jnp.sum(jf.apply({"params": p}, jnp.asarray(x))["res5"]
                                           * ct))(params)
        pf = WSResNet(depth=14, res5_dilation=res5_dilation, freeze_at=freeze_at, **WIDTHS)
        pf.load_state_dict(pm.state_dict())
        (pf(_nchw(x))["res5"] * _nchw(ct)).sum().backward()
        named = dict(pf.named_parameters())
        flat = {".".join(str(k.key) for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
        for path, g in flat.items():
            name = path.replace(".kernel", ".weight")
            if name not in named:     # a FrozenBN statistic: a buffer here
                assert name.rsplit(".", 1)[-1] in ("weight", "bias", "running_mean",
                                                   "running_var") and not g.any(), path
                continue
            p = named[name]
            if not p.requires_grad:
                assert name.startswith(("stem.", "res2_")) and freeze_at == 2 and not g.any()
                continue
            np.testing.assert_allclose(p.grad.numpy().transpose(2, 3, 1, 0), g, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(g).max()), err_msg=name)
        assert len(named) == sum(1 for k in flat if k.endswith("kernel"))


def test_build_ws_resnet_reads_the_config_as_jax_does():
    """``build_ws_resnet`` takes depth, freeze_at, the outputs, res5's
    dilation and the widths from MODEL.RESNETS and MODEL.BACKBONE, as the
    JAX `build_ws_resnet` does: the same parameter tree, strides and channels."""
    opts = ["MODEL.RESNETS.DEPTH", "14", "MODEL.RESNETS.RES5_DILATION", "2",
            "MODEL.BACKBONE.FREEZE_AT", "3", "MODEL.RESNETS.OUT_FEATURES", "['res4', 'res5']",
            "MODEL.RESNETS.STEM_OUT_CHANNELS", "8", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
            "MODEL.RESNETS.WIDTH_PER_GROUP", "4"]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    jm = jax_ws.build_ws_resnet(jcfg)
    pm = build_ws_resnet(cfg)
    x = jnp.zeros((1, 32, 32, 3))
    tree = state_dict_from_flax(jm.init(jax.random.PRNGKey(0), x)["params"])
    assert {k: tuple(v.shape) for k, v in tree.items()} == {
        k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert pm.out_features == jm.out_features == ("res4", "res5")
    assert pm.stride == jm.out_feature_strides["res5"] == 8
    assert pm.out_channels == jm.out_feature_channels["res5"] == 128
    frozen = {n.split(".")[0] for n, p in pm.named_parameters() if not p.requires_grad}
    assert frozen == {"stem", "res2_block0", "res3_block0"}


def test_stride_shapes_of_the_jax_tests():
    """tests/test_backbones_ws.py:11 and :28 at (1, 64, 64): stride 8 with
    res5_dilation 2 (every stage 8 x 8, res5 128 channels), stride 16 with
    1 (res5 4 x 4)."""
    x = torch.zeros(1, 3, 64, 64)
    out = WSResNet(depth=14, res5_dilation=2, out_features=("res2", "res3", "res4", "res5"),
                   **WIDTHS)(x)
    assert all(out[k].shape[2:] == (8, 8) for k in out) and out["res5"].shape[1] == 16 * 8
    out = WSResNet(depth=14, res5_dilation=1, out_features=("res5",), **WIDTHS)(x)
    assert out["res5"].shape[2:] == (4, 4)
