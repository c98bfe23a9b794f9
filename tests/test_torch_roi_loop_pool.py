"""The port's ROILoopPool (sos_wsod_torch/ops/roi_loop_pool.py) against the
JAX package's ``roi_loop_pool``, the reference golden and a numpy oracle of
the reference CUDA kernel, on the CPU where the plain version runs. Its CUDA
kernel (csrc/roi_loop_pool_fwd.cu) is held against this plain version on the
card (tests/test_torch_roi_loop_pool_cuda.py, chip_smoke.py phase 4e).

Tolerances: a max pool selects an input value, and the windows and exclusion
rectangles are integers computed in f32 in the JAX op's order, so the
forward is exact in f32 and in bf16. The backward is the ROIPool backward at
the first hit; JAX differentiates its sparse-table max and maximum(o, 0),
which split ties, so the gradients are compared on strictly positive,
tie-free f32 features, where both route each bin's cotangent to its one
maximum: equal within f32 summation order (a cell sums up to dozens of
products in another order: rtol 1e-5, atol 1e-6 of the largest entry; 1e-6
against the golden's np.add.at).
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import jax

from sos_wsod_tpu.ops.roi_loop_pool import roi_loop_pool as jax_roi_loop_pool
from sos_wsod_torch.kernels.roi_loop_pool import roi_loop_pool_fwd_cuda
from sos_wsod_torch.ops.roi_loop_pool import (
    loop_windows,
    roi_loop_pool,
    roi_loop_pool_reference,
)

GOLD = pathlib.Path(__file__).resolve().parent / "goldens" / "roi_loop_pool.npz"


def oracle(feat_hwc, rois, spatial_scale, pooled, ratio=1.8):
    """numpy transliteration of the reference ROILoopPool CUDA kernel (max
    initialized at 0): (3P, C, pooled, pooled) [box; frame; context]."""
    h, w, c = feat_hwc.shape
    p = rois.shape[0]
    out = np.zeros((3 * p, c, pooled, pooled), np.float32)

    def bounds(g, rs, size, limit):
        s = int(np.floor(g * size / pooled)) + rs
        e = int(np.ceil((g + 1) * size / pooled)) + rs
        return min(max(s, 0), limit), min(max(e, 0), limit)

    def snap(v):
        return int(np.floor(v * spatial_scale + 0.5))

    def pool(row, n, rect, excl):
        rs_w, rs_h, re_w, re_h = (snap(v) for v in rect)
        roi_w, roi_h = max(re_w - rs_w + 1, 1), max(re_h - rs_h + 1, 1)
        e_h1, e_w1, e_h2, e_w2 = excl
        for ph in range(pooled):
            hs, he = bounds(ph, rs_h, roi_h, h)
            for pw in range(pooled):
                ws, we = bounds(pw, rs_w, roi_w, w)
                for ci in range(c):
                    m = 0.0
                    for yy in range(hs, he):
                        for xx in range(ws, we):
                            if not (e_h1 < yy < e_h2 and e_w1 < xx < e_w2):
                                m = max(m, feat_hwc[yy, xx, ci])
                    out[row * p + n, ci, ph, pw] = m

    for n in range(p):
        x1, y1, x2, y2 = rois[n]
        rw, rh = x2 - x1, y2 - y1
        in_w, in_h = (rw - rw / ratio) / 2, (rh - rh / ratio) / 2
        out_w, out_h = (rw * ratio - rw) / 2, (rh * ratio - rh) / 2
        mx, my = w / spatial_scale, h / spatial_scale
        inner = (np.clip(x1 + in_w, 0, mx), np.clip(y1 + in_h, 0, my),
                 np.clip(x2 - in_w, 0, mx), np.clip(y2 - in_h, 0, my))
        outer = (np.clip(x1 - out_w, 0, mx), np.clip(y1 - out_h, 0, my),
                 np.clip(x2 + out_w, 0, mx), np.clip(y2 + out_h, 0, my))
        none = (0, 0, 0, 0)
        pool(0, n, (x1, y1, x2, y2), none)
        pool(1, n, (x1, y1, x2, y2), (snap(inner[1]), snap(inner[0]), snap(inner[3]),
                                      snap(inner[2])))
        pool(2, n, outer, (snap(y1), snap(x1), snap(y2), snap(x2)))
    return out


def _boxes(rng, p, h, w, scale):
    x1 = rng.uniform(0, w / scale * 0.6, p)
    y1 = rng.uniform(0, h / scale * 0.6, p)
    x2 = x1 + rng.uniform(8, w / scale * 0.4 - 1, p)
    y2 = y1 + rng.uniform(8, h / scale * 0.4 - 1, p)
    boxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
    boxes[0] = [0, 0, w / scale, h / scale]                      # the whole image
    boxes[1] = [w / scale - 6, h / scale - 6, w / scale, h / scale]  # a corner, tiny
    return boxes


def _port(feat, boxes, valid, scale, rs=None, dtype=torch.float32, argmax=False):
    return roi_loop_pool(torch.from_numpy(feat).to(dtype), torch.from_numpy(boxes),
                         torch.from_numpy(valid), None if rs is None else torch.from_numpy(rs),
                         spatial_scale=scale, return_argmax=argmax)


@pytest.mark.parametrize("seed,hwc,p", [(0, (24, 32, 3), 16), (1, (17, 29, 5), 24),
                                        (2, (40, 56, 8), 48)])
def test_matches_jax_op_and_oracle(seed, hwc, p):
    """f32 features with negative values: out equals the JAX op and the
    numpy oracle exactly, invalid slots included."""
    rng = np.random.RandomState(seed)
    h, w, c = hwc
    feat = rng.randn(h, w, c).astype(np.float32)
    scale = 0.25
    boxes = _boxes(rng, p, h, w, scale)
    valid = rng.rand(p) > 0.2
    want = np.asarray(jax_roi_loop_pool(jnp.asarray(feat), jnp.asarray(boxes),
                                        jnp.asarray(valid), spatial_scale=scale,
                                        output_size=(7, 7)))
    got = _port(feat, boxes, valid, scale).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(feat, boxes, scale, 7)
                                  * np.tile(valid, 3)[:, None, None, None])


def test_bf16_and_row_scale_match_jax():
    """bf16 features: equal to the JAX op in bf16, and the row scale is a
    bf16 multiply after the max (the JAX heads' objectness weighting)."""
    rng = np.random.RandomState(3)
    feat = rng.randn(20, 28, 16).astype(np.float32)
    boxes = _boxes(rng, 12, 20, 28, 0.125)
    valid = np.ones(12, bool)
    rs = rng.uniform(1, 2, 12).astype(np.float32)
    want = jax_roi_loop_pool(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes),
                             jnp.asarray(valid), spatial_scale=0.125, output_size=(7, 7))
    want = want * jnp.tile(jnp.asarray(rs), 3).astype(jnp.bfloat16)[:, None, None, None]
    got = _port(feat, boxes, valid, 0.125, rs, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy().transpose(0, 3, 1, 2),
                                  np.asarray(want, np.float32))


def test_box_rows_and_argmax_match_reference_golden():
    """The golden is the reference's CPU ROILoopPool, a plain ROIPool of the
    box with a -FLT_MAX floor: the box rows equal max(golden, 0), and pos is
    the golden argmax wherever the golden value is above 0, else -1. The
    gradient of the box rows is the golden's, with the cotangent of bins at
    or below 0 dropped (their cells get none here)."""
    z = np.load(GOLD)
    feat = z["feat"][0].transpose(1, 2, 0).copy()
    boxes = z["rois"][:, 1:].copy()
    p = boxes.shape[0]
    scale = float(z["spatial_scale"])
    out, pos = _port(feat, boxes, np.ones(p, bool), scale, argmax=True)
    ref = z["out"]
    np.testing.assert_array_equal(out[:p].numpy().transpose(0, 3, 1, 2), np.maximum(ref, 0))
    want_pos = np.where(ref > 0, z["argmax"], -1)
    np.testing.assert_array_equal(pos[:p].numpy().transpose(0, 3, 1, 2), want_pos)

    f = torch.from_numpy(feat).requires_grad_(True)
    out = roi_loop_pool(f, torch.from_numpy(boxes), torch.ones(p, dtype=torch.bool),
                        spatial_scale=scale)
    g = np.zeros((3 * p,) + out.shape[1:], np.float32)
    g[:p] = z["grad_out"].transpose(0, 2, 3, 1)
    out.backward(torch.from_numpy(g))
    h, w, c = feat.shape
    want = np.zeros((c, h * w), np.float32)
    go = np.where(ref > 0, z["grad_out"], 0).transpose(1, 0, 2, 3).reshape(c, -1)
    am = z["argmax"].transpose(1, 0, 2, 3).reshape(c, -1)
    for ci in range(c):
        np.add.at(want[ci], am[ci], go[ci])
    np.testing.assert_allclose(f.grad.numpy().transpose(2, 0, 1).reshape(c, -1), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradient_matches_jax_on_positive_tie_free_features(seed):
    """Strictly positive, tie-free f32 features (a permutation of distinct
    values): the gradient with a row scale equals jax.grad of the JAX op
    times the same scale."""
    rng = np.random.RandomState(10 + seed)
    h, w, c, p = 20, 30, 6, 14
    feat = (rng.permutation(h * w * c).reshape(h, w, c).astype(np.float32) + 1.0) / (h * w * c)
    boxes = _boxes(rng, p, h, w, 0.25)
    valid = np.arange(p) < p - 2
    rs = rng.uniform(1, 2, p).astype(np.float32)
    cot = rng.randn(3 * p, 7, 7, c).astype(np.float32)

    def jax_loss(f):
        o = jax_roi_loop_pool(f, jnp.asarray(boxes), jnp.asarray(valid), spatial_scale=0.25,
                              output_size=(7, 7))
        o = o * jnp.tile(jnp.asarray(rs), 3)[:, None, None, None]
        return jnp.sum(o * jnp.asarray(cot.transpose(0, 3, 1, 2)))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_(True)
    out = roi_loop_pool(f, torch.from_numpy(boxes), torch.from_numpy(valid),
                        torch.from_numpy(rs), spatial_scale=0.25)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_windows_and_reference_semantics():
    """The box and frame rows share the box's windows, the context rows take
    the outer box's; a bin whose kept cells are all at or below 0 gives 0
    and pos -1; pos lies in its row's window (kernel A bwd's precondition);
    invalid slots give 0 and -1 in all three rows."""
    rng = np.random.RandomState(4)
    h, w, c, p = 16, 24, 4, 10
    feat = torch.from_numpy(rng.randn(h, w, c).astype(np.float32))
    feat[:6, :8] = -1.0
    boxes = torch.from_numpy(_boxes(rng, p, h, w, 0.25))
    boxes[2] = torch.tensor([0.0, 0.0, 20.0, 16.0])      # on the negative block
    valid = torch.arange(p) < p - 1
    hs, he, ws, we, ex = loop_windows(boxes, valid, h, w, 7, 7, 0.25)
    assert torch.equal(hs[:p], hs[p:2 * p]) and torch.equal(ws[:p], ws[p:2 * p])
    assert (he[2 * p:] - hs[2 * p:]).sum() >= (he[:p] - hs[:p]).sum()
    assert not ex[:p].any()
    out, pos = roi_loop_pool_reference(feat, hs, he, ws, we, ex, valid)
    assert not out[[2, p + 2]].any() and (pos[[2, p + 2]] == -1).all()
    y, x = pos // w, pos % w
    live = pos >= 0
    assert ((y >= hs[:, :, None, None]) & (y < he[:, :, None, None])
            & (x >= ws[:, None, :, None]) & (x < we[:, None, :, None]) | ~live).all()
    for r in (p - 1, 2 * p - 1, 3 * p - 1):
        assert not out[r].any() and (pos[r] == -1).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises: a CPU tensor is refused, and
    the op only takes the plain version for a tensor on the CPU."""
    feat = torch.zeros(8, 8, 4)
    win = loop_windows(torch.tensor([[0.0, 0.0, 16.0, 16.0]]), torch.tensor([True]), 8, 8, 7, 7,
                       0.25)
    with pytest.raises(ValueError, match="CUDA tensor"):
        roi_loop_pool_fwd_cuda(feat, *win, torch.tensor([True]))
