"""The port's ROIPool backward (sos_wsod_torch/ops/roi_pool.py:
RoIPoolFunction, roi_pool_backward_reference) against the JAX package's
ROIPool VJPs, on the CPU where the plain version runs. Its CUDA kernel is
held against this plain version on the card (tests/test_torch_roi_pool_cuda.py,
chip_smoke.py).

Semantics: the gradient routes to the first hit among tied maxima, like
``roi_pool_fused`` (the Pallas kernel, run here in interpret mode) and
``_roi_pool_argmax``. The JAX training path ``roi_pool_multi`` splits tied
gradients instead, so it is compared only on f32 inputs without ties. Zeros
from ReLU and from padding tie in the model, but the ReLU and mask backward
zero the gradient on both sides, so the parameter gradients still agree
(tests/test_torch_train_slice.py).

Tolerances: the scatter-add runs in f32 in both packages, in the same
element order on the CPU, and both cast once to the feature dtype, so the
bf16 cases are exact; against ``roi_pool_multi`` the table-chain backward
adds the same products in another order (f32, |d| <= 1e-5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_roi_pool import _mixed_boxes
from sos_wsod_tpu.ops.pallas.roi_pool_fused import roi_pool_fused
from sos_wsod_tpu.ops.roi_pool import _roi_pool_argmax, roi_pool_multi
from sos_wsod_torch.ops.roi_pool import (
    bin_windows,
    roi_pool,
    roi_pool_backward_reference,
    roi_pool_reference,
)


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """Round to the nearest bf16 value, kept as f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _port_grad(feat, boxes, valid, rs, g, dtype):
    f = torch.from_numpy(feat).to(dtype).requires_grad_(True)
    out = roi_pool(f, torch.from_numpy(boxes), torch.from_numpy(valid),
                   None if rs is None else torch.from_numpy(rs), spatial_scale=0.125)
    out.backward(torch.from_numpy(g).to(dtype))
    return f.grad


@pytest.mark.parametrize("hwc,p", [((24, 40, 64), 12), ((40, 64, 128), 24), ((35, 44, 128), 16)])
def test_grad_matches_pallas_vjp_interpret(hwc, p):
    """bf16 features with the row scale: the gradient equals the VJP of
    roi_pool_fused (interpret mode). The scale is a bf16 value, as the
    model's objectness weighting is in bf16 (rcnn_wsl.py:139)."""
    h, w, c = hwc
    rng = np.random.RandomState(1)
    feat = rng.randn(h, w, c).astype(np.float32)
    boxes = _mixed_boxes(rng, p, h * 8, w * 8)
    valid = rng.rand(p) > 0.2
    rs = _bf16_values(rng.uniform(1, 2, p))
    g = _bf16_values(rng.randn(p, 7, 7, c))

    def loss(f):
        out = roi_pool_fused(f, jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(rs),
                             0.125, (7, 7), True)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(g))

    want = jax.grad(loss)(jnp.asarray(feat, jnp.bfloat16))
    got = _port_grad(feat, boxes, valid, rs, g, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (h, w, c) and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_tie_plateau_routes_to_first_hit_exactly():
    """Constant features, g = 1, no scale: every bin adds exactly 1 at its
    window's smallest flat y*W+x, as the Pallas VJP does."""
    h, w, c = 16, 32, 8
    feat = np.ones((h, w, c), np.float32)
    boxes = np.asarray([[16.0, 16.0, 112.0, 96.0], [0.0, 0.0, 255.0, 127.0]], np.float32)
    valid = np.ones(2, bool)
    g = np.ones((2, 7, 7, c), np.float32)

    def loss(f):
        return roi_pool_fused(f, jnp.asarray(boxes), jnp.asarray(valid), None,
                              0.125, (7, 7), True).astype(jnp.float32).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(feat, jnp.bfloat16)), np.float32)
    got = _port_grad(feat, boxes, valid, None, g, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2 * 49 * c and got[2, 2, 0] >= 1


def test_grad_matches_argmax_key_vjp():
    """bf16 without a scale: the gradient equals the VJP of the JAX
    argmax-key path (_roi_pool_argmax), invalid slots included."""
    h, w, c, p = 20, 36, 16, 18
    rng = np.random.RandomState(4)
    feat = rng.randn(h, w, c).astype(np.float32)
    boxes = _mixed_boxes(rng, p, h * 8, w * 8)
    valid = rng.rand(p) > 0.25
    g = _bf16_values(rng.randn(p, 7, 7, c))

    def loss(f):
        out = _roi_pool_argmax(f, jnp.asarray(boxes), jnp.asarray(valid), 0.125, (7, 7))
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(g.transpose(0, 3, 1, 2)))

    want = jax.grad(loss)(jnp.asarray(feat, jnp.bfloat16))
    got = _port_grad(feat, boxes, valid, None, g, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_grad_matches_roi_pool_multi_without_ties():
    """f32, two views of different sizes with random (tie-free) features
    and interior boxes: the per-view gradients equal roi_pool_multi's."""
    rng = np.random.RandomState(6)
    shapes, p, c = [(12, 16), (10, 14)], 10, 8
    feats = [rng.randn(h, w, c).astype(np.float32) for h, w in shapes]
    boxes = []
    for h, w in shapes:   # interior boxes of at least 2 cells
        x1, y1 = rng.uniform(0, w * 8 - 24, p), rng.uniform(0, h * 8 - 24, p)
        boxes.append(np.stack([x1, y1, np.minimum(x1 + rng.uniform(16, w * 4, p), w * 8 - 8),
                               np.minimum(y1 + rng.uniform(16, h * 4, p), h * 8 - 8)], 1))
    boxes = np.stack(boxes).astype(np.float32)
    valid = rng.rand(p) > 0.2
    rs = rng.uniform(1, 2, p).astype(np.float32)
    g = rng.randn(len(shapes), p, 7, 7, c).astype(np.float32)

    def loss(fs):
        out = roi_pool_multi(fs, jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(rs),
                             spatial_scale=0.125, output_size=(7, 7))
        return jnp.vdot(out, jnp.asarray(g))

    want = jax.grad(loss)(tuple(jnp.asarray(f) for f in feats))
    for v in range(len(shapes)):
        got = _port_grad(feats[v], boxes[v], valid, rs, g[v], torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[v]), rtol=1e-5, atol=1e-5)


def test_gradcheck_f64_tie_free():
    """torch.autograd.gradcheck of the Function in f64 on random features
    (no two cells of a window within the finite-difference step)."""
    rng = np.random.RandomState(8)
    h, w, c, p = 6, 9, 3, 5
    feat = torch.from_numpy(rng.randn(h, w, c)).requires_grad_(True)
    boxes = torch.from_numpy(_mixed_boxes(rng, p, h * 8, w * 8))
    valid = torch.tensor([True, True, False, True, True])
    rs = torch.from_numpy(rng.uniform(1, 2, p)).float()
    assert torch.autograd.gradcheck(
        lambda f: roi_pool(f, boxes, valid, rs, spatial_scale=0.125), (feat,), eps=1e-6,
        atol=1e-5)


def test_no_gradient_for_boxes_and_row_scale():
    """Only the feature map gets a gradient: objectness is input data."""
    rng = np.random.RandomState(2)
    feat = torch.from_numpy(rng.randn(8, 10, 4).astype(np.float32)).requires_grad_(True)
    boxes = torch.from_numpy(_mixed_boxes(rng, 6, 64, 80)).requires_grad_(True)
    rs = torch.from_numpy(rng.uniform(1, 2, 6).astype(np.float32)).requires_grad_(True)
    out = roi_pool(feat, boxes, torch.ones(6, dtype=torch.bool), rs, spatial_scale=0.125)
    out.sum().backward()
    assert feat.grad is not None and float(feat.grad.abs().sum()) > 0
    assert boxes.grad is None and rs.grad is None


def test_backward_reference_matches_numpy_scatter():
    """The plain backward is the f32 scatter-add of g x rs at pos, skipping
    pos < 0, against an f64 numpy loop (f32 rounding of short sums: rtol 1e-6)."""
    rng = np.random.RandomState(3)
    h, w, c, p = 10, 12, 5, 9
    feat = torch.from_numpy(rng.randn(h, w, c).astype(np.float32))
    boxes = torch.from_numpy(_mixed_boxes(rng, p, h * 8, w * 8))
    valid = torch.from_numpy(rng.rand(p) > 0.3)
    _, pos = roi_pool_reference(feat, *bin_windows(boxes, valid, h, w, 7, 7, 0.125), valid)
    g = rng.randn(p, 7, 7, c).astype(np.float32)
    rs = rng.uniform(1, 2, p).astype(np.float32)
    got = roi_pool_backward_reference(torch.from_numpy(g), pos, torch.from_numpy(rs), h, w)
    want = np.zeros((h * w, c), np.float64)
    pos_np = pos.numpy().reshape(-1, c)
    g_np = (g.astype(np.float64) * rs[:, None, None, None]).reshape(-1, c)
    for i in range(pos_np.shape[0]):
        m = pos_np[i] >= 0
        np.add.at(want, (pos_np[i][m], np.arange(c)[m]), g_np[i][m])
    assert got.dtype == torch.float32 and (pos < 0).any()
    np.testing.assert_allclose(got.numpy().reshape(h * w, c), want, rtol=1e-6, atol=1e-6)
