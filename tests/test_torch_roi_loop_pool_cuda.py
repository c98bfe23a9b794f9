"""The CUDA ROILoopPool forward (sos_wsod_torch/csrc/roi_loop_pool_fwd.cu)
against its plain PyTorch version, and its backward (kernel A bwd over the 3P
rows) against the plain backward run on the CPU, on the card. Marked
``cuda``: skipped where torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_loop_pool_cuda.py -q

The kernel has a staged branch (tiles of the map in shared memory, windows
larger than a tile's region read from the map) and a direct one (channel
counts that do not fill 16-byte vectors, misaligned tensors); the main
path's inputs at P = 4096 are checked at the production map (87 x 119), a
map whose last tiles are narrow (87 x 161), the top training map (152 x 204)
and the widest (152 x 250 at MAX_SIZE_TRAIN 2000), at 3 channels (direct),
136 and 512 (staged), and at the production map misaligned (direct), the
branch as the library reports it.

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


@pytest.mark.parametrize("hw", [(87, 119), (87, 161), (152, 204), (152, 250)])
@pytest.mark.parametrize("channels", [3, 136, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain_version_at_each_branch(device, hw, channels, dtype):
    """The main path's inputs (4000 proposals in 4096 slots) at each map:
    equal to the plain version, on the branch the library reports: staged
    where the channels fill 16-byte vectors, else direct."""
    feat32, win, ex, valid, rs = bench.case_inputs(device, (*hw, channels))
    feat = feat32.to(dtype)
    bench.check(feat, win, ex, valid, rs)
    staged = channels * feat.element_size() % 16 == 0
    assert bench.branch_of(feat, win, ex, valid, rs) == ("staged" if staged else "direct")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_misaligned_map_takes_the_direct_branch(device, dtype):
    feat32, win, ex, valid, rs = bench.case_inputs(device, (87, 119, 512))
    feat = bench.misaligned(feat32.to(dtype))
    assert feat.data_ptr() % 16 != 0
    assert bench.branch_of(feat, win, ex, valid, rs) == "direct"
    bench.check(feat, win, ex, valid, rs)


@pytest.mark.parametrize("hw", [(87, 119), (152, 204)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_constant_map(device, hw, dtype):
    """Every bin's answer is its first kept cell (the first hit of ties)."""
    _, win, ex, valid, rs = bench.case_inputs(device, (*hw, 64))
    feat = torch.full((*hw, 64), 1.5, dtype=dtype, device=device)
    bench.check(feat, win, ex, valid, rs)


@pytest.mark.parametrize("hw", [(87, 119), (152, 204)])
def test_signed_zeros_and_nan(device, hw):
    """Cells of -0, +0 and NaN among positive ones: the running maximum
    stays +0 over -0 and skips NaN, with and without pos (without pos the
    bf16 maximum is __hmax2)."""
    feat32, win, ex, valid, rs = bench.case_inputs(device, (*hw, 64))
    gen = torch.Generator(device=device).manual_seed(7)
    pick = torch.rand(feat32.shape, generator=gen, device=device)
    feat32 = torch.where(pick < 0.4, torch.tensor(-0.0, device=device), feat32.abs())
    feat32 = torch.where((pick > 0.4) & (pick < 0.5), torch.tensor(0.0, device=device), feat32)
    feat32 = torch.where(pick > 0.98, torch.tensor(float("nan"), device=device), feat32)
    feat32[:30] = -0.0
    for dtype in (torch.bfloat16, torch.float32):
        bench.check(feat32.to(dtype), win, ex, valid, rs)


def test_wrapper_refuses_maps_wider_than_the_offsets(device):
    feat = torch.zeros((1, 65536, 8), dtype=torch.bfloat16, device=device)
    win = loop_windows(torch.tensor([[0.0, 0.0, 8.0, 8.0]], device=device),
                       torch.tensor([True], device=device), 1, 65536, 7, 7, 0.125)
    with pytest.raises(ValueError, match="16-bit offsets"):
        kernel.roi_loop_pool_fwd_cuda(feat, *win, torch.tensor([True], device=device))


def test_wrapper_refuses_windows_it_does_not_read(device):
    """Frame windows other than the box rows', or a box row with a
    rectangle of its own: the kernel reads neither, so the wrapper raises
    before it launches."""
    feat32, boxes, valid, rs = bench.adversarial_inputs(device, 8, seed=4)
    win = loop_windows(boxes, valid, 24, 40, 7, 7, 0.125)
    p = valid.shape[0]
    before = kernel.launches
    shifted = [t.clone() for t in win]
    shifted[0][p:p + 20] = (shifted[0][p:p + 20] - 1).clamp(min=0)
    boxed = [t.clone() for t in win]
    boxed[4][:10] = boxed[4][p:p + 10]
    for bad in (shifted, boxed):
        with pytest.raises(ValueError, match="frame rows' windows"):
            kernel.roi_loop_pool_fwd_cuda(feat32, *bad, valid, rs)
    assert kernel.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_equals_plain_backward_on_the_cpu(device, dtype):
    feat32, boxes, valid, rs = bench.adversarial_inputs(device, 136, seed=2)
    h, w, _ = feat32.shape
    win = loop_windows(boxes, valid, h, w, 7, 7, 0.125)
    g, pos, rs3, valid3 = bench._backward_inputs(feat32.to(dtype), win, valid, rs, 2)
    bench.check_bwd(g, pos, rs3, win[:4], valid3, h, w)


def test_op_runs_the_kernel_forward_and_backward(device):
    feat32, boxes, valid, rs = bench.adversarial_inputs(device, 64, seed=3)
    before, staged = kernel.launches, kernel.branch_launches["staged"]
    f = feat32.to(torch.bfloat16).requires_grad_(True)
    out = roi_loop_pool(f, boxes, valid, rs, spatial_scale=0.125)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.branch_launches["staged"] == staged + 1
    assert f.grad is not None and torch.isfinite(f.grad.float()).all()
