"""The CUDA multi-level ROIAlign backward (sos_wsod_torch/csrc/roi_align_bwd.cu)
against the plain backward, on the card. Marked ``cuda``: skipped where
torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_align_bwd_cuda.py -q

The kernel adds each cell's terms in the plain backward's order with the
same f32 operations, so each level's gradient is held equal, bit for bit,
to the plain backward run on the CPU, and to itself across two launches
(tools/bench_roi_align.py:check_bwd): at the training step's shapes (512
ROIs, 704 x 960 and 1216 x 1664 canvases), at the mask head's 14 x 14 bins,
on the forward's adversarial cases, and through autograd (the forward
kernel, then the backward kernel, each launched once).
"""
from __future__ import annotations

import pytest
import torch

from sos_wsod_torch.kernels import roi_align as fwd_kernel
from sos_wsod_torch.kernels import roi_align_bwd as kernel
from sos_wsod_torch.models.roi_heads.standard import assign_boxes_to_levels, multilevel_roi_align
from sos_wsod_torch.ops.roi_align import roi_align_levels_backward_reference
from sos_wsod_torch.tools import bench_roi_align as bench

pytestmark = pytest.mark.cuda

CASES = ("sample_cap 16", "sampling_ratio 2", "sampling_ratio 3", "sampling_ratio 20",
         "aligned False", "C 3", "C 12", "whole map p2", "whole map p2, sample_cap 16",
         "long ROIs, 1344 wide")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("canvas,image_hw", [(bench.CANVAS, bench.IMAGE_HW),
                                             (bench.TOP_CANVAS, bench.TOP_IMAGE_HW)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_within_tolerance_at_the_training_shapes(device, dtype, canvas,
                                                                 image_hw):
    n = kernel.launches
    assert bench.check_bwd(*bench.bwd_inputs(device, dtype, 1, canvas, image_hw)) == 0.0
    assert kernel.launches == n + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_at_the_mask_heads_14x14_bins(device, dtype):
    """196 bins a ROI, more than a pass of the walk takes at 7 x 7."""
    assert bench.check_bwd(*bench.bwd_inputs(device, dtype, 4, output_size=(14, 14))) == 0.0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_adversarial(device, dtype, case):
    args, kw = bench.bwd_adversarial_cases(device, dtype)[case]
    assert bench.check_bwd(*args, **kw) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_invalid_rois_add_nothing(device, dtype):
    grad, shapes, boxes, valid, level, scales = bench.bwd_inputs(device, dtype, 2, p=64)
    got = kernel.roi_align_bwd_cuda(grad, shapes, boxes, torch.zeros_like(valid), level, scales)
    assert all(g.dtype == dtype and not g.any() for g in got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_runs_both_kernels(device, dtype):
    """multilevel_roi_align on feature maps that require grad: one forward
    and one backward launch, and the features' gradients equal to the plain
    backward of the same upstream gradient run on the CPU, bit for bit."""
    feats, boxes, valid, _, _ = bench.fpn_inputs(device, dtype, 3, p=bench.TRAIN_ROIS)
    leaves = [f.clone().requires_grad_() for f in feats]
    n_fwd, n_bwd = fwd_kernel.launches, kernel.launches
    out = multilevel_roi_align(leaves, bench.STRIDES, boxes, valid)
    g = torch.randn(out.shape, device=device).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    assert (fwd_kernel.launches, kernel.launches) == (n_fwd + 1, n_bwd + 1)
    level = assign_boxes_to_levels(boxes, 2, 5)
    want = roi_align_levels_backward_reference(g.cpu(), [tuple(f.shape[:2]) for f in feats],
                                               boxes.cpu(), valid.cpu(), level.cpu(),
                                               [1.0 / s for s in bench.STRIDES])
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(bench.bits(a.cpu()), bench.bits(w))
