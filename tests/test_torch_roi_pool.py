"""Parity of the port's ROIPool (sos_wsod_torch/ops/roi_pool.py) with the JAX
package's ROIPool paths, the reference golden and the numpy oracle.

The port's plain PyTorch version is what a CPU tensor runs; its CUDA kernel
is held against this plain version on the card by chip_smoke.py. Every
comparison here is exact: max pooling selects an input value, and the
row_scale multiply is one rounding of an exact product in either framework.
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_golden_case import _mixed_rois
from oracles import roi_pool_np
from sos_wsod_tpu.ops.pallas.roi_pool_fused import _roi_pool_fused_fwd_impl
from sos_wsod_tpu.ops.roi_pool import (
    _bin_windows,
    _roi_pool_argmax_fwd_impl,
    roi_pool as jax_roi_pool,
)
from sos_wsod_torch.kernels.roi_pool import roi_pool_fwd_cuda
from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool

GOLD = pathlib.Path(__file__).parent / "goldens"


def _mixed_boxes(rng, p, img_h, img_w):
    """Random boxes plus the whole-image, sub-cell, corner and sliver cases."""
    x1 = rng.uniform(0, img_w - 10, p)
    y1 = rng.uniform(0, img_h - 10, p)
    x2 = np.minimum(x1 + rng.uniform(2, img_w / 2, p), img_w)
    y2 = np.minimum(y1 + rng.uniform(2, img_h / 2, p), img_h)
    boxes = np.stack([x1, y1, x2, y2], 1)
    boxes[0] = [0, 0, img_w, img_h]
    boxes[1] = [5, 5, 6, 6]
    boxes[2] = [img_w - 4, img_h - 4, img_w, img_h]
    boxes[3] = [0, 0, 3, img_h]
    return boxes.astype(np.float32)


def _torch_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


@pytest.mark.parametrize("hw", [(40, 64), (35, 44)])   # aligned + ragged W
def test_bf16_matches_jax_first_hit_argmax(hw):
    """bf16 values and first-hit positions equal the JAX argmax-key path,
    with and without the row_scale epilogue and with invalid slots."""
    h, w = hw
    c, p = 16, 24
    rng = np.random.RandomState(0)
    feat = rng.randn(h, w, c).astype(np.float32)
    boxes = _mixed_boxes(rng, p, h * 8, w * 8)
    valid = rng.rand(p) > 0.2
    rs = rng.uniform(1, 2, p).astype(np.float32)

    ref_out, ref_pos = _roi_pool_argmax_fwd_impl(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), jnp.asarray(valid),
        0.125, (7, 7))
    ref = jnp.transpose(ref_out, (0, 2, 3, 1))
    ref_scaled = jnp.where(ref_pos >= 0,
                           ref * jnp.asarray(rs)[:, None, None, None].astype(jnp.bfloat16), 0)

    args = (_torch_bf16(feat), torch.from_numpy(boxes), torch.from_numpy(valid))
    out, pos = roi_pool(*args, spatial_scale=0.125, return_argmax=True)
    assert out.dtype == torch.bfloat16 and pos.dtype == torch.int32
    np.testing.assert_array_equal(_np(pos), np.asarray(ref_pos))
    np.testing.assert_array_equal(_np(out), np.asarray(ref, np.float32))
    out_s = roi_pool(*args, torch.from_numpy(rs), spatial_scale=0.125)
    np.testing.assert_array_equal(_np(out_s), np.asarray(ref_scaled, np.float32))


def test_tie_plateau_routes_to_first_hit():
    """Constant features: every window cell ties, and pos is the window's
    smallest flat y*W+x (the case of tests/test_pallas_roi_pool.py)."""
    h, w, c = 16, 32, 8
    feat = np.ones((h, w, c), np.float32)
    boxes = np.asarray([[16.0, 16.0, 112.0, 96.0], [0.0, 0.0, 255.0, 127.0]], np.float32)
    valid = np.ones(2, bool)
    _, ref_pos = _roi_pool_argmax_fwd_impl(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), jnp.asarray(valid),
        0.125, (7, 7))
    out, pos = roi_pool(_torch_bf16(feat), torch.from_numpy(boxes), torch.from_numpy(valid),
                        spatial_scale=0.125, return_argmax=True)
    np.testing.assert_array_equal(_np(pos), np.asarray(ref_pos))
    assert pos[0, 0, 0, 0] == 2 * 32 + 2
    assert torch.all(out == 1)


def test_f32_matches_jax_table_path():
    """f32 channels-last output with row_scale equals JAX roi_pool."""
    h, w, c, p = 30, 44, 8, 20
    rng = np.random.RandomState(3)
    feat = rng.randn(h, w, c).astype(np.float32)
    boxes = _mixed_boxes(rng, p, h * 8, w * 8)
    valid = rng.rand(p) > 0.25
    rs = rng.uniform(1, 2, p).astype(np.float32)
    ref = jax_roi_pool(jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(valid),
                       jnp.asarray(rs), spatial_scale=0.125, channels_last=True)
    out = roi_pool(torch.from_numpy(feat), torch.from_numpy(boxes),
                   torch.from_numpy(valid), torch.from_numpy(rs), spatial_scale=0.125)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bf16_matches_pallas_kernel_interpret():
    """The plain version equals the Pallas kernel it replaces, run in
    interpret mode: values, row_scale epilogue and positions."""
    h, w, c, p = 20, 36, 128, 10
    rng = np.random.RandomState(5)
    feat = rng.randn(h, w, c).astype(np.float32)
    boxes = _mixed_boxes(rng, p, h * 8, w * 8)
    valid = rng.rand(p) > 0.2
    rs = rng.uniform(1, 2, p).astype(np.float32)
    ref_out, ref_pos = _roi_pool_fused_fwd_impl(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(rs), spatial_scale=0.125, output_size=(7, 7), interpret=True)
    out, pos = roi_pool(_torch_bf16(feat), torch.from_numpy(boxes), torch.from_numpy(valid),
                        torch.from_numpy(rs), spatial_scale=0.125, return_argmax=True)
    np.testing.assert_array_equal(_np(pos), np.asarray(ref_pos))
    np.testing.assert_array_equal(_np(out), np.asarray(ref_out, np.float32))


def test_bf16_matches_reference_golden():
    """Values and argmax equal the reference's compiled CPU kernel on a
    bf16-quantized map (goldens/roi_pool_bf16.npz; its argmax is (y, x)-flat
    per channel)."""
    z = np.load(GOLD / "roi_pool_bf16.npz")
    feat = _torch_bf16(z["feat"][0].transpose(1, 2, 0).copy())
    boxes = torch.from_numpy(z["rois"][:, 1:].copy())
    valid = torch.ones(boxes.shape[0], dtype=torch.bool)
    out, pos = roi_pool(feat, boxes, valid, spatial_scale=float(z["spatial_scale"]),
                        return_argmax=True)
    np.testing.assert_array_equal(_np(out).transpose(0, 3, 1, 2), z["out"])
    np.testing.assert_array_equal(_np(pos).transpose(0, 3, 1, 2), z["argmax"])


def test_f32_matches_numpy_oracle():
    h, w, c, p = 24, 32, 6, 18
    rng = np.random.RandomState(9)
    feat = (rng.randn(h, w, c) * 2).astype(np.float32)
    boxes = _mixed_boxes(rng, p, h * 8, w * 8)
    out = roi_pool(torch.from_numpy(feat), torch.from_numpy(boxes),
                   torch.ones(p, dtype=torch.bool), spatial_scale=0.125)
    exp = roi_pool_np(feat.transpose(2, 0, 1), boxes, 0.125, 7, 7)
    np.testing.assert_array_equal(out.numpy().transpose(0, 3, 1, 2), exp)


def test_bin_windows_match_jax():
    """Integer bin bounds equal JAX _bin_windows, including the .5 rounding
    edges of the model golden, overhanging boxes and invalid slots."""
    h, w = 12, 16
    rng = np.random.RandomState(23)
    rois = _mixed_rois(rng, 40, h * 8, w * 8)[:, 1:]
    over = np.asarray([[-20.0, -9.0, 40.0, 300.0], [100.0, 90.0, 400.0, 500.0],
                       [3.49, 3.5, 3.51, 4.5]], np.float32)
    boxes = np.concatenate([rois, over]).astype(np.float32)
    valid = np.ones(len(boxes), bool)
    valid[5] = False
    for scale in (0.125, 0.0625):
        ref = _bin_windows(jnp.asarray(boxes), jnp.asarray(valid), h, w, 7, 7, scale)
        got = bin_windows(torch.from_numpy(boxes), torch.from_numpy(valid), h, w, 7, 7, scale)
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors only; it never runs the
    plain version instead."""
    z = torch.zeros((2, 7), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        roi_pool_fwd_cuda(torch.zeros((4, 4, 8)), z, z, z, z, torch.ones(2, dtype=torch.bool))
