"""The CUDA ROILoopPool forward (sos_wsod_torch/csrc/roi_loop_pool_fwd.cu)
against its plain PyTorch version, and its backward (kernel A bwd over the 3P
rows) against the plain backward run on the CPU, on the card. Marked
``cuda``: skipped where torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_loop_pool_cuda.py -q

A max pool selects an input value and the scale multiply is one rounding of
an exact product, so kernel and plain version agree bit for bit; the
backward adds each cell's products in ascending row order, the order of the
plain version's index_add_ on the CPU, so it is bit-identical to it.
"""
from __future__ import annotations

import pytest
import torch

from sos_wsod_torch.kernels import roi_loop_pool as kernel
from sos_wsod_torch.ops.roi_loop_pool import loop_windows, roi_loop_pool
from sos_wsod_torch.tools import bench_roi_loop_pool as bench

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("channels", [136, 3, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain_version(device, channels, dtype):
    feat32, boxes, valid, rs = bench.adversarial_inputs(device, channels, seed=1)
    h, w, _ = feat32.shape
    hs, he, ws, we, ex = loop_windows(boxes, valid, h, w, 7, 7, 0.125)
    bench.check(feat32.to(dtype), (hs, he, ws, we), ex, valid, rs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_equals_plain_backward_on_the_cpu(device, dtype):
    feat32, boxes, valid, rs = bench.adversarial_inputs(device, 136, seed=2)
    h, w, _ = feat32.shape
    win = loop_windows(boxes, valid, h, w, 7, 7, 0.125)
    g, pos, rs3, valid3 = bench._backward_inputs(feat32.to(dtype), win, valid, rs, 2)
    bench.check_bwd(g, pos, rs3, win[:4], valid3, h, w)


def test_op_runs_the_kernel_forward_and_backward(device):
    feat32, boxes, valid, rs = bench.adversarial_inputs(device, 64, seed=3)
    before = kernel.launches
    f = feat32.to(torch.bfloat16).requires_grad_(True)
    out = roi_loop_pool(f, boxes, valid, rs, spatial_scale=0.125)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert f.grad is not None and torch.isfinite(f.grad.float()).all()
