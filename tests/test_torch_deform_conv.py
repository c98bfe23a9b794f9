"""The port's deformable convolution (sos_wsod_torch/ops/deform_conv.py) and
DeformBottleneckBlock (models/backbones/resnet_ws.py) against the JAX
package's (sos_wsod_tpu/ops/deform_conv.py, models/backbones/resnet_ws.py:92),
on the CPU in f32.

Tolerances: forward within rtol 1e-5 + atol 1e-5 x the output's largest
entry; the gradients with respect to x, the offsets, the modulation and the
weight (for the block: its input and every parameter) within rtol 1e-4 +
atol 1e-4 x the gradient's largest entry. Both sides compute the bilinear
corners in the same order and differ in the order of the GEMM's sums and of
the gathers' scatter-add in the backward. On the card the gather's backward
(``index_add_``) adds its rows in an order that changes from run to run, so
there the gradient of x repeats to rounding, not bit for bit (ROADMAP
Queue 3).

The block's JAX parameter tree is carried across by
``engine/weights.py:state_dict_from_flax`` (the raw ``conv2_kernel`` HWIO ->
OIHW) and loaded strictly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sos_wsod_tpu.models.backbones.resnet_ws import DeformBottleneckBlock as JaxBlock
from sos_wsod_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from sos_wsod_torch.engine.weights import state_dict_from_flax
from sos_wsod_torch.models.backbones.resnet_ws import DeformBottleneckBlock
from sos_wsod_torch.ops.deform_conv import deform_conv2d


def _close(got, want, rtol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=name)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(2, 0, 1)[None]))


CASES = {"plain": dict(stride=1, dilation=1, modulated=False, bias=False),
         "modulated": dict(stride=1, dilation=1, modulated=True, bias=True),
         "stride2": dict(stride=2, dilation=1, modulated=True, bias=False),
         "dilation2": dict(stride=1, dilation=2, modulated=False, bias=True)}


@pytest.mark.parametrize("name", list(CASES))
def test_deform_conv2d_matches_jax(name):
    """Offsets of a few pixels, so that taps fall between cells and outside
    the map; forward and the gradients of x, offset, mask and weight."""
    case = CASES[name]
    s, d = case["stride"], case["dilation"]
    rng = np.random.default_rng(0)
    h, w, ci, co = 11, 13, 6, 5
    ho, wo = (h + 2 * d - 2 * d - 1) // s + 1, (w + 2 * d - 2 * d - 1) // s + 1
    x = rng.normal(size=(h, w, ci)).astype(np.float32)
    off = (rng.normal(size=(ho, wo, 18)) * 2.5).astype(np.float32)
    wt = (rng.normal(size=(3, 3, ci, co)) * 0.2).astype(np.float32)
    m = rng.uniform(size=(ho, wo, 9)).astype(np.float32) if case["modulated"] else None
    b = rng.normal(size=(co,)).astype(np.float32) if case["bias"] else None
    g = rng.normal(size=(ho, wo, co)).astype(np.float32)
    args = [x, off, wt] + ([m] if m is not None else [])

    def jf(*a):
        return jax_deform_conv2d(a[0], a[1], a[2], a[3] if m is not None else None,
                                 None if b is None else jnp.asarray(b), stride=s, padding=d,
                                 dilation=d)

    want, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    want_grads = vjp(jnp.asarray(g))

    tx, toff = _nchw(x).requires_grad_(), _nchw(off).requires_grad_()
    tw = torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()).requires_grad_()
    tm = _nchw(m).requires_grad_() if m is not None else None
    out = deform_conv2d(tx, toff, tw, tm, None if b is None else torch.from_numpy(b),
                        stride=s, padding=d, dilation=d)
    assert out.shape == (1, co, ho, wo)
    out.backward(_nchw(g))
    _close(out.detach()[0].permute(1, 2, 0).numpy(), want, 1e-5, "forward")
    _close(tx.grad[0].permute(1, 2, 0).numpy(), want_grads[0], 1e-4, "x")
    _close(toff.grad[0].permute(1, 2, 0).numpy(), want_grads[1], 1e-4, "offset")
    _close(tw.grad.permute(2, 3, 1, 0).numpy(), want_grads[2], 1e-4, "weight")
    if m is not None:
        _close(tm.grad[0].permute(1, 2, 0).numpy(), want_grads[3], 1e-4, "mask")


def test_deform_conv2d_zero_offsets_is_conv():
    """At zero offsets and no modulation, the convolution of a batch."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 4, 9, 10)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(3, 4, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))
    for s, d in ((1, 1), (2, 1), (1, 2)):
        want = F.conv2d(x, wt, b, stride=s, padding=d, dilation=d)
        off = torch.zeros(2, 18, *want.shape[2:])
        got = deform_conv2d(x, off, wt, None, b, stride=s, padding=d, dilation=d)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_deform_conv2d_checks_the_offset_shape():
    with pytest.raises(ValueError, match="offset"):
        deform_conv2d(torch.zeros(1, 2, 5, 5), torch.zeros(1, 18, 4, 5), torch.zeros(3, 2, 3, 3))


def _randomize(params, rng, offset_scale):
    """FrozenBN statistics at random, and conv2_offset's kernel and bias
    nonzero: offsets of a few pixels."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if path and path[-1].endswith("_norm"):
                a = (rng.uniform(0.5, 1.5, a.shape) if k in ("weight", "running_var")
                     else rng.normal(0, 0.1, a.shape)).astype(np.float32)
            elif path and path[-1] == "conv2_offset":
                a = rng.normal(0, offset_scale, a.shape).astype(np.float32)
            out[k] = a
        return out
    return walk(params, ())


BLOCKS = {"v1": dict(modulated=False, dilation=1, pool=(False, 1), cin=8),
          "v2": dict(modulated=True, dilation=1, pool=(False, 1), cin=8),
          "v2-dilated-pool": dict(modulated=True, dilation=2, pool=(True, 1), cin=16),
          "v1-pool2": dict(modulated=False, dilation=1, pool=(True, 2), cin=16)}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_deform_bottleneck_block_matches_jax(name):
    """Both variants (with a stride-1 edge-padded pool, a stride-2 pool and
    dilation 2): the JAX tree carried across and loaded strictly, then the
    forward and the gradients of the input and of every parameter."""
    case = BLOCKS[name]
    rng = np.random.default_rng(2)
    cin, cout, bott = case["cin"], 16, 8
    has_pool, pool_stride = case["pool"]
    jblk = JaxBlock(in_channels=cin, out_channels=cout, bottleneck_channels=bott,
                    dilation=case["dilation"], deform_modulated=case["modulated"],
                    has_pool=has_pool, pool_stride=pool_stride)
    x = rng.normal(size=(1, 12, 14, cin)).astype(np.float32)
    params = _randomize(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng, 0.3)

    def loss(p, xx):
        out = jblk.apply({"params": p}, xx)
        return jnp.sum(out * jnp.asarray(gout)), out

    gout = rng.normal(size=jax.eval_shape(lambda: jblk.apply({"params": params},
                                                             jnp.asarray(x))).shape)
    gout = gout.astype(np.float32)
    (_, want), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    blk = DeformBottleneckBlock(cin, cout, bott, dilation=case["dilation"],
                                deform_modulated=case["modulated"],
                                pool_stride=pool_stride if has_pool else 0)
    blk.load_state_dict(state_dict_from_flax(params), strict=True)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = blk(tx)
    (out * torch.from_numpy(gout.transpose(0, 3, 1, 2).copy())).sum().backward()
    _close(out.detach().permute(0, 2, 3, 1).numpy(), want, 1e-5, "forward")
    # the offsets are a few pixels: the deformable path is exercised
    off = blk.conv2_offset(F.relu(blk.conv1_norm(blk.conv1(tx)))).detach()
    assert 0.3 < float(off[:, :18].abs().mean()) < 5
    _close(tx.grad.permute(0, 2, 3, 1).numpy(), g_x, 1e-4, "input")
    n = 0
    for pname, p in blk.named_parameters():
        *path, leaf = pname.split(".")
        node = g_params
        for k in path:
            node = node[k]
        g = np.asarray(node["kernel" if leaf == "weight" else leaf])
        got = p.grad.numpy()
        got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got
        _close(got, g, 1e-4, pname)
        assert np.abs(g).max() > 0, pname
        n += 1
    assert n == (6 if cin != cout else 5)


def test_deform_bottleneck_block_starts_as_a_plain_bottleneck():
    """conv2_offset is zero at init: the deformable conv is then the plain
    3x3 conv of conv2_kernel."""
    torch.manual_seed(0)
    blk = DeformBottleneckBlock(8, 8, 4, deform_modulated=False)
    assert not blk.conv2_offset.weight.any() and not blk.conv2_offset.bias.any()
    x = torch.randn(1, 8, 7, 9)
    h = F.relu(blk.conv1_norm(blk.conv1(x)))
    want = F.conv2d(h, blk.conv2_kernel, padding=1)
    got = deform_conv2d(h, torch.zeros(1, 18, 7, 9), blk.conv2_kernel)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert blk(x).shape == (1, 8, 7, 9)
