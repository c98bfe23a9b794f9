"""The port's ROIAlign (sos_wsod_torch/ops/roi_align.py) against the JAX
package's roi_align and multilevel_roi_align, and the reference goldens.

Tolerances: the plain version does the JAX function's f32 operations in the
same order, but XLA:CPU contracts the sample-position arithmetic into FMAs,
which moves a sample's weights by an ulp or so, so f32 outputs are held
within 1e-4 relative plus 5e-5 absolute (the features are unit normals, the
outputs means of at most 64 samples; the largest difference seen was 2.8e-5,
6e-5 relative). The goldens are held at the
tolerance of tests/test_reference_goldens.py (rtol 1e-4, atol 1e-5), with the
sample cap raised to 16 as there, since the goldens' whole-image ROI has an
adaptive grid of 10. The multi-level layout pools each box on its own level
only, where JAX sums every level's masked result: the values are equal, and
the one difference allowed, a -0 that the JAX sum turns into +0, compares
equal.
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.roi_heads.standard import (
    assign_boxes_to_levels as jax_assign,
    multilevel_roi_align as jax_multilevel,
)
from sos_wsod_tpu.ops.roi_align import roi_align as jax_roi_align
from sos_wsod_torch.kernels import roi_align as kernel
from sos_wsod_torch.models.roi_heads.standard import assign_boxes_to_levels, multilevel_roi_align
from sos_wsod_torch.ops.roi_align import roi_align
from sos_wsod_torch.tools.bench_roi_align import fpn_inputs

GOLD = pathlib.Path(__file__).parent / "goldens"
RTOL, ATOL = 1e-4, 5e-5


def _boxes(rng, p, h, w, scale):
    """Boxes in image coordinates of an (h, w) map at ``scale``: ordinary,
    tiny, partly outside, reversed, and whole-image ones (grid capped)."""
    ih, iw = h / scale, w / scale
    x1, y1 = rng.uniform(-10, iw, p), rng.uniform(-10, ih, p)
    b = np.stack([x1, y1, x1 + rng.uniform(0.5, iw / 2, p), y1 + rng.uniform(0.5, ih / 2, p)], 1)
    b[0] = [0, 0, iw, ih]
    b[1] = [-30, -30, iw + 40, ih + 40]
    b[2] = [5, 5, 5.2, 5.1]
    b[3] = [20, 20, 10, 12]
    return b.astype(np.float32)


@pytest.mark.parametrize("aligned,sampling", [(True, 0), (False, 0), (True, 2), (False, 2)])
def test_roi_align_matches_jax(aligned, sampling):
    rng = np.random.default_rng(int(aligned) * 10 + sampling)
    h, w, c, p, scale = 19, 27, 12, 40, 0.25
    feat = rng.standard_normal((h, w, c)).astype(np.float32)
    boxes = _boxes(rng, p, h, w, scale)
    valid = rng.uniform(0, 1, p) > 0.1
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), torch.from_numpy(valid),
                    spatial_scale=scale, sampling_ratio=sampling, aligned=aligned)
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(valid),
                                    spatial_scale=scale, sampling_ratio=sampling,
                                    aligned=aligned))
    assert got.shape == (p, c, 7, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[torch.from_numpy(~valid)].any()


@pytest.mark.parametrize("tag,aligned,sampling", [("roi_align_s0_v1", False, 0),
                                                  ("roi_align_s0_v2", True, 0),
                                                  ("roi_align_s2_v1", False, 2),
                                                  ("roi_align_s2_v2", True, 2)])
def test_roi_align_matches_reference_goldens(tag, aligned, sampling):
    z = np.load(GOLD / f"{tag}.npz")
    feat = torch.from_numpy(z["feat"][0].transpose(1, 2, 0).copy())
    boxes = torch.from_numpy(z["rois"][:, 1:].copy())
    out = roi_align(feat, boxes, torch.ones(boxes.shape[0], dtype=torch.bool),
                    spatial_scale=float(z["spatial_scale"]), sampling_ratio=sampling,
                    aligned=aligned, sample_cap=16)
    np.testing.assert_allclose(out.numpy(), z["out"], rtol=1e-4, atol=1e-5, err_msg=tag)


def test_multilevel_layout_matches_jax():
    """One pass over p2-p5, each box from its own level, against the JAX
    masked sum over levels; the level assignment is exact."""
    feats, boxes, valid, level, scales = fpn_inputs("cpu", torch.float32, seed=1, p=80, c=8)
    jl = np.asarray(jax_assign(jnp.asarray(boxes.numpy()), 2, 5))
    np.testing.assert_array_equal(level.numpy(), jl)
    assert len(np.unique(jl[valid.numpy()])) == 4           # every level pools something
    got = multilevel_roi_align(feats, (4, 8, 16, 32), boxes, valid)
    want = np.asarray(jax_multilevel([jnp.asarray(f.numpy()) for f in feats], (4, 8, 16, 32),
                                     jnp.asarray(boxes.numpy()), jnp.asarray(valid.numpy())))
    assert got.shape == (80, 8, 7, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_assign_boxes_to_levels_matches_jax():
    rng = np.random.default_rng(0)
    side = np.exp(rng.uniform(np.log(1), np.log(1500), (500, 2)))
    b = np.concatenate([np.zeros((500, 2)), side], 1).astype(np.float32)
    b[:4, 2:] = [[0, 0], [112, 112], [224, 224], [448, 448]]     # empty and canonical sizes
    got = assign_boxes_to_levels(torch.from_numpy(b), 2, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_assign(jnp.asarray(b), 2, 5)))
    assert got.dtype == np.int32 and list(got[:4]) == [0, 1, 2, 3]


def test_bf16_features_pool_to_bf16():
    """bf16 maps: the products and sums in f32 and one rounding to bf16 at
    the end, as the JAX function computes them, so the bf16 result is the
    f32 result on the same (bf16-valued) maps rounded once: exactly."""
    feats, boxes, valid, _, _ = fpn_inputs("cpu", torch.bfloat16, seed=5, p=40, c=16)
    got = multilevel_roi_align(feats, (4, 8, 16, 32), boxes, valid)
    f32 = multilevel_roi_align([f.float() for f in feats], (4, 8, 16, 32), boxes, valid)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_plain_version_is_differentiable_on_cpu():
    rng = np.random.default_rng(1)
    feat = torch.from_numpy(rng.standard_normal((10, 12, 4)).astype(np.float32)).requires_grad_()
    boxes = torch.tensor([[4.0, 4.0, 30.0, 28.0], [0.0, 0.0, 47.0, 39.0]])
    out = roi_align(feat, boxes, torch.ones(2, dtype=torch.bool), spatial_scale=0.25)
    (g,) = torch.autograd.grad(out.square().sum(), feat)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    feats, boxes, valid, level, scales = fpn_inputs("cpu", torch.float32, seed=0, p=4, c=8,
                                                    canvas=(64, 64), image_hw=(64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.roi_align_fwd_cuda(feats, boxes, valid, level, scales)


def test_traffic_bytes_at_the_fpn_shapes():
    """p2-p5 of the 704 x 960 canvas in bf16 read once (28.7 MB) and 1000
    ROIs x 49 bins x 256 written once (25.1 MB)."""
    feats = [torch.empty((h, w, 256), dtype=torch.bfloat16, device="meta")
             for h, w in ((176, 240), (88, 120), (44, 60), (22, 30))]
    n = kernel.traffic_bytes(feats, 1000)
    assert n == 56100 * 512 + 1000 * 49 * 512 + 1000 * 21
    assert round(56100 * 512 / 1e6, 1) == 28.7 and round(1000 * 49 * 512 / 1e6, 1) == 25.1
