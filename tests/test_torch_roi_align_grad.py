"""The gradient of the port's ROIAlign (sos_wsod_torch/ops/roi_align.py: the
plain backward ``roi_align_levels_backward_reference`` and the autograd
Function behind ``roi_align_levels``) against jax.vjp of the JAX package's
multilevel_roi_align and roi_align, on the CPU in f32; and what the CPU can
check of the backward kernel (csrc/roi_align_bwd.cu): its geometry is the
forward kernel's, text for text, its tables sum in the plain backward's
order, and its wrapper and bound.

Tolerances: XLA puts (g / count) x w_k onto each sample's corners; the
plain backward puts (g / count x Y) x X onto each cell of a bin, Y and X
the sums of the bin's sample factors on the cell's row and column (the same
function, factored); both sum in f32, in different orders (XLA's
scatter-add, torch's index_add_); XLA:CPU also contracts the sample
positions into FMAs (tests/test_torch_roi_align.py), which moves a weight
by an ulp or so. The gradients are held within 1e-4 relative plus 1e-5 x
the largest entry. The autograd Function on the CPU runs the plain forward
and the plain backward, so its gradient equals the plain backward's bit for
bit.
"""
from __future__ import annotations

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.roi_heads.standard import multilevel_roi_align as jax_multilevel
from sos_wsod_tpu.ops.roi_align import roi_align as jax_roi_align
from sos_wsod_torch.kernels import roi_align_bwd as bwd_kernel
from sos_wsod_torch.models.roi_heads.standard import assign_boxes_to_levels, multilevel_roi_align
from sos_wsod_torch.ops.roi_align import roi_align, roi_align_levels_backward_reference
from sos_wsod_torch.tools.bench_roi_align import fpn_inputs

CSRC = pathlib.Path(__file__).resolve().parents[1] / "sos_wsod_torch" / "csrc"
STRIDES = (4, 8, 16, 32)
RTOL, ATOL_SCALE = 1e-4, 1e-5


def _inputs(seed, p=24, c=8):
    """p2-p5 of a 96 x 128 canvas and ROIs of every level (sides of 8 to
    700 px), every seventh invalid."""
    feats, _, _, _, scales = fpn_inputs("cpu", torch.float32, seed, p=p, c=c,
                                        canvas=(96, 128), image_hw=(90, 120))
    rng = np.random.default_rng(seed)
    side = np.array([8, 20, 60, 150, 300, 700])[np.arange(p) % 6, None] * \
        rng.uniform(0.8, 1.25, (p, 2))
    xy = rng.uniform(-10, 100, (p, 2))
    b = torch.from_numpy(np.concatenate([xy, xy + side], 1).astype(np.float32))
    valid = torch.from_numpy(np.arange(p) % 7 != 3)
    return feats, b, valid, assign_boxes_to_levels(b, 2, 5), scales


def _grad_upstream(p, c, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((p, c, 7, 7))
                            .astype(np.float32))


def _assert_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL_SCALE * float(np.abs(w).max()) + 1e-7)


@pytest.mark.parametrize("sampling", [2, 0])
def test_backward_matches_jax_vjp_multilevel(sampling):
    """jax.vjp of multilevel_roi_align (each box on its level, the levels
    summed under masks) against the plain backward and against the autograd
    Function's gradient; fixed 2 x 2 grids and the adaptive grid."""
    feats, boxes, valid, level, scales = _inputs(sampling)
    g = _grad_upstream(boxes.shape[0], feats[0].shape[-1], 10 + sampling)
    _, vjp = jax.vjp(lambda fs: jax_multilevel(fs, STRIDES, jnp.asarray(boxes.numpy()),
                                               jnp.asarray(valid.numpy()),
                                               sampling_ratio=sampling),
                     [jnp.asarray(f.numpy()) for f in feats])
    (want,) = vjp(jnp.asarray(g.numpy()))
    shapes = [tuple(f.shape[:2]) for f in feats]
    ref = roi_align_levels_backward_reference(g, shapes, boxes, valid, level, scales,
                                              sampling_ratio=sampling)
    _assert_close(ref, want)
    assert all(r.abs().sum() > 0 for r in ref)   # every level gets a gradient

    leaves = [f.clone().requires_grad_() for f in feats]
    out = multilevel_roi_align(leaves, STRIDES, boxes, valid, sampling_ratio=sampling)
    got = torch.autograd.grad((out * g).sum(), leaves)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("aligned", [True, False])
def test_backward_matches_jax_vjp_one_level(aligned):
    """One level, the adaptive grid at its cap (whole-image, outside,
    reversed and tiny ROIs): ``roi_align``'s gradient against jax.vjp of
    the JAX roi_align."""
    rng = np.random.default_rng(int(aligned))
    h, w, c, p, scale = 13, 17, 6, 12, 0.25
    feat = rng.standard_normal((h, w, c)).astype(np.float32)
    xy = rng.uniform(-10, 60, (p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 40, (p, 2))], 1).astype(np.float32)
    boxes[0] = [0, 0, w / scale, h / scale]
    boxes[1] = [-30, -30, w / scale + 40, h / scale + 40]
    boxes[2] = [20, 20, 10, 12]
    valid = rng.uniform(0, 1, p) > 0.15
    g = _grad_upstream(p, c, 3)
    _, vjp = jax.vjp(lambda x: jax_roi_align(x, jnp.asarray(boxes), jnp.asarray(valid),
                                             spatial_scale=scale, aligned=aligned),
                     jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g.numpy()))
    leaf = torch.from_numpy(feat).requires_grad_()
    out = roi_align(leaf, torch.from_numpy(boxes), torch.from_numpy(valid), spatial_scale=scale,
                    aligned=aligned)
    (got,) = torch.autograd.grad((out * g).sum(), leaf)
    _assert_close([got], [want])


def test_bf16_backward_is_the_f32_sums_rounded_once():
    """bf16 features: the gradient is summed in f32 and rounded once to
    bf16, so it equals the f32 backward's result cast to bf16 exactly."""
    feats, boxes, valid, level, scales = _inputs(5)
    g = _grad_upstream(boxes.shape[0], feats[0].shape[-1], 5).to(torch.bfloat16)
    shapes = [tuple(f.shape[:2]) for f in feats]
    got = roi_align_levels_backward_reference(g, shapes, boxes, valid, level, scales)
    f32 = roi_align_levels_backward_reference(g.float(), shapes, boxes, valid, level, scales)
    for a, b in zip(got, f32):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


def test_boxes_and_invalid_rois_get_no_gradient():
    """Invalid ROIs add nothing, whatever their upstream gradient; the boxes
    are not differentiated."""
    feats, boxes, valid, level, scales = _inputs(7)
    boxes.requires_grad_()
    leaves = [f.clone().requires_grad_() for f in feats]
    out = multilevel_roi_align(leaves, STRIDES, boxes, torch.zeros_like(valid))
    *grads, box_grad = torch.autograd.grad(out.sum() * 3.0, [*leaves, boxes], allow_unused=True)
    assert all(not g.any() for g in grads)
    assert box_grad is None


def _device_fn(name: str, source: str) -> str:
    m = re.search(r"__device__ __forceinline__ \w+ " + name + r"\(.*?\n}\n", source, re.S)
    assert m, name
    return m.group(0)


@pytest.mark.parametrize("name", ["sample_pos", "axis_cells"])
def test_backward_kernel_geometry_is_the_forward_kernels(name):
    """The backward kernel's sample positions, clamps and weights are copies
    of the forward kernel's device functions, so both kernels see the same
    samples, bit for bit."""
    fwd = (CSRC / "roi_align_fwd.cu").read_text()
    bwd = (CSRC / "roi_align_bwd.cu").read_text()
    assert _device_fn(name, fwd) == _device_fn(name, bwd)


def test_backward_kernel_tables_sum_in_the_plain_order():
    """The kernel's row and column tables (``axis_table``) take each sample
    of the bin in order from the forward's geometry and add, from +0 and
    rounded once each, its lo factor then its hi factor to their cells: the
    order of ``ops/roi_align.py:_axis_sums``."""
    fn = _device_fn("axis_table", (CSRC / "roi_align_bwd.cu").read_text())
    body = re.sub(r"//.*", "", fn)
    assert "sum[k] = 0.f;" in body
    assert "for (int i = 0; i < g; ++i)" in body
    assert "axis_cells(sample_pos(start, bin, g, b, i), n)" in body
    lo = body.index("if (lo == k) sum[k] = __fadd_rn(sum[k], a.h);")
    hi = body.index("if (hi == k) sum[k] = __fadd_rn(sum[k], a.l);")
    assert lo < hi and body.count("sum[k] =") == 3


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    feats, boxes, valid, level, scales = _inputs(1)
    g = torch.zeros((boxes.shape[0], 7, 7, feats[0].shape[-1]))
    with pytest.raises(ValueError, match="CUDA"):
        bwd_kernel.roi_align_bwd_cuda(g, [tuple(f.shape[:2]) for f in feats], boxes, valid,
                                      level.int(), scales)


def test_backward_traffic_bytes_at_the_training_shapes():
    """512 sampled ROIs x 49 bins x 256 of g read in bf16 (12.8 MB), p2-p5
    of the 704 x 960 canvas written once (28.7 MB)."""
    shapes = [(176, 240), (88, 120), (44, 60), (22, 30)]
    n = bwd_kernel.traffic_bytes(shapes, 256, 512, 2)
    assert n == 512 * 49 * 512 + 56100 * 512 + 512 * 21
    assert round(512 * 49 * 512 / 1e6, 1) == 12.8 and round(56100 * 512 / 1e6, 1) == 28.7
