"""The CUDA ROIPool kernels (sos_wsod_torch/csrc/roi_pool_fwd.cu and
roi_pool_bwd.cu) against their plain PyTorch versions, on the card. Marked
``cuda``: skipped where torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_pool_cuda.py -q

Forward: max pooling selects an input value and the scale multiply is one
rounding of an exact product, so kernel and plain version agree bit for bit,
at small shapes and at the real ones (the production inputs of
``sos_wsod_torch/tools/bench_roi_pool.py`` on full-size maps).
Backward: the kernel adds each cell's f32 products in ascending bin order,
the order of the plain version's index_add_ on the CPU, so its map equals the
plain version run on the CPU bit for bit, and is the same in every launch,
at small shapes and at the real ones.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from sos_wsod_torch.kernels import roi_pool as kernel
from sos_wsod_torch.kernels import roi_pool_bwd as bwd_kernel
from sos_wsod_torch.ops.roi_pool import (
    bin_windows,
    roi_pool,
    roi_pool_backward_reference,
    roi_pool_reference,
)
from sos_wsod_torch.tools.bench_roi_pool import production_pool_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device, h, w, c, p, dtype, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    feat = rng.randn(h, w, c).astype(np.float32)
    if ties:
        feat = np.round(feat)            # many tied values per window
    img_h, img_w = h * 8, w * 8
    x1 = rng.uniform(-20, img_w, p)
    y1 = rng.uniform(-20, img_h, p)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, img_w, p), y1 + rng.uniform(0, img_h, p)], 1)
    boxes[:3] = [[0, 0, img_w, img_h], [5, 5, 6, 6], [img_w - 4, img_h - 4, img_w + 40, img_h + 40]]
    valid = rng.rand(p) > 0.2
    rs = rng.uniform(1, 2, p).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(feat).to(dtype), t(boxes.astype(np.float32)), t(valid), t(rs)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", [(9, 13, 1), (20, 33, 3), (35, 44, 200), (40, 64, 512)])
@pytest.mark.parametrize("ties", [False, True])
def test_kernel_bit_identical_to_plain(device, dtype, hwc, ties):
    h, w, c = hwc
    feat, boxes, valid, rs = _inputs(device, h, w, c, 37, dtype, ties=ties)
    win = bin_windows(boxes, valid, h, w, 7, 7, 0.125)
    for scale in (None, rs):
        out_k, pos_k = kernel.roi_pool_fwd_cuda(feat, *win, valid, scale)
        out_p, pos_p = roi_pool_reference(feat, *win, valid, scale)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out_k), _bits(out_p))
        assert torch.equal(pos_k, pos_p)
    # without the argmax output, the scaled values are the same
    out_n, pos_n = kernel.roi_pool_fwd_cuda(feat, *win, valid, rs, return_argmax=False)
    assert pos_n is None and torch.equal(_bits(out_n), _bits(out_k))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", [(87, 119, 512), (152, 256, 512), (86, 500, 512),
                                 (87, 119, 1), (87, 119, 3), (87, 119, 200)])
def test_kernel_bit_identical_at_real_shapes(device, dtype, hwc):
    """P = 4096 slots (4000 live) on the inference map (87x119), the largest
    VOC training map (152x256, canvas 1216x2048) and the 688x4000 test
    canvas's map (86x500), with a tie plateau and the whole-image, sub-cell,
    corner, sliver and plateau boxes; 512 channels and the masked tails of
    1, 3 and 200; with and without scale and pos."""
    h, w, c = hwc
    feat32, boxes, valid, rs = production_pool_inputs(device, hwc)
    feat = feat32.to(dtype)
    win = bin_windows(boxes, valid, h, w, 7, 7, 0.125)
    for scale in (None, rs):
        out_p, pos_p = roi_pool_reference(feat, *win, valid, scale)
        out_k, pos_k = kernel.roi_pool_fwd_cuda(feat, *win, valid, scale)
        out_n, pos_n = kernel.roi_pool_fwd_cuda(feat, *win, valid, scale, return_argmax=False)
        torch.cuda.synchronize()
        assert pos_n is None
        assert torch.equal(_bits(out_k), _bits(out_p))
        assert torch.equal(pos_k, pos_p)
        assert torch.equal(_bits(out_n), _bits(out_p))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_on_a_misaligned_map(device, dtype):
    """A map whose data does not start on 16 bytes (a view one element into
    its storage) takes the same kernel's one-channel-at-a-time loads and
    stores, and agrees bit for bit."""
    h, w, c = 20, 33, 64
    feat, boxes, valid, rs = _inputs(device, h, w, c, 37, dtype, ties=True)
    shifted = torch.cat([feat.new_zeros(1), feat.flatten()])[1:].view(h, w, c)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    win = bin_windows(boxes, valid, h, w, 7, 7, 0.125)
    out_k, pos_k = kernel.roi_pool_fwd_cuda(shifted, *win, valid, rs)
    out_p, pos_p = roi_pool_reference(feat, *win, valid, rs)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out_k), _bits(out_p)) and torch.equal(pos_k, pos_p)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", [(280, 2000, 3), (1, 462000, 3)])
def test_kernel_on_windows_wider_than_a_chunk(device, dtype, hwc):
    """Windows whose cells span more than 0xffff flat positions, which the
    kernel scans in chunks (bf16 positions are 16-bit offsets within one):
    whole rows a chunk on the 280x2000 map, pieces of one 66000-cell row on
    the 1x462000 map; rounded values tie across the chunks' borders."""
    h, w, c = hwc
    feat, boxes, valid, rs = _inputs(device, h, w, c, 3, dtype, ties=True)
    win = bin_windows(boxes, valid, h, w, 7, 7, 0.125)
    assert int((win[1] - win[0]).max() - 1) * w + int((win[3] - win[2]).max()) > 0xffff
    out_k, pos_k = kernel.roi_pool_fwd_cuda(feat, *win, valid, rs)
    out_p, pos_p = roi_pool_reference(feat, *win, valid, rs)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out_k), _bits(out_p)) and torch.equal(pos_k, pos_p)


def test_public_roi_pool_goes_through_the_kernel(device):
    feat, boxes, valid, rs = _inputs(device, 16, 24, 64, 10, torch.bfloat16)
    before = kernel.launches
    out, pos = roi_pool(feat, boxes, valid, rs, spatial_scale=0.125, return_argmax=True)
    assert kernel.launches == before + 1
    cpu_out, cpu_pos = roi_pool(feat.cpu(), boxes.cpu(), valid.cpu(), rs.cpu(),
                                spatial_scale=0.125, return_argmax=True)
    assert torch.equal(_bits(out.cpu()), _bits(cpu_out)) and torch.equal(pos.cpu(), cpu_pos)
    empty = roi_pool(feat, boxes[:0], valid[:0], rs[:0], spatial_scale=0.125)
    assert empty.shape == (0, 7, 7, 64) and kernel.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    feat, boxes, valid, rs = _inputs(device, 16, 24, 64, 10, torch.bfloat16)
    win = bin_windows(boxes, valid, 16, 24, 7, 7, 0.125)
    with pytest.raises(ValueError, match="dtype"):
        kernel.roi_pool_fwd_cuda(feat.half(), *win, valid, rs)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.roi_pool_fwd_cuda(feat.transpose(0, 1), *win, valid, rs)
    with pytest.raises(ValueError, match="dtype"):
        kernel.roi_pool_fwd_cuda(feat, *win, valid, rs.double())
    with pytest.raises(ValueError, match="on cpu"):
        kernel.roi_pool_fwd_cuda(feat, *win, valid.cpu(), rs)


def _backward_inputs(feat, boxes, valid, rs, g_dtype, seed=1):
    """Windows, pos from the forward kernel, a random cotangent and the
    scales rounded to its type, on the card."""
    h, w, _ = feat.shape
    win = bin_windows(boxes, valid, h, w, 7, 7, 0.125)
    _, pos = kernel.roi_pool_fwd_cuda(feat, *win, valid, rs)
    g = torch.randn(pos.shape, generator=torch.Generator(feat.device).manual_seed(seed),
                    device=feat.device).to(g_dtype)
    return g, pos, rs.to(g_dtype).float(), win


def _assert_backward_exact(g, pos, scale, win, valid, h, w):
    """The kernel's map equals the plain version on the CPU bit for bit, and
    a second launch gives the same bits."""
    acc_k = bwd_kernel.roi_pool_bwd_cuda(g, pos, scale, *win, valid, h, w)
    again = bwd_kernel.roi_pool_bwd_cuda(g, pos, scale, *win, valid, h, w)
    acc_p = roi_pool_backward_reference(g.cpu(), pos.cpu(), None if scale is None else scale.cpu(),
                                        h, w)
    torch.cuda.synchronize()
    assert acc_k.dtype == torch.float32 and acc_k.shape == (h, w, g.shape[3])
    assert torch.equal(acc_k.view(torch.int32), again.view(torch.int32))
    assert torch.equal(acc_k.cpu().view(torch.int32), acc_p.view(torch.int32))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", [(9, 13, 1), (20, 33, 3), (35, 44, 200), (40, 64, 512)])
@pytest.mark.parametrize("ties", [False, True])
def test_backward_kernel_matches_plain(device, g_dtype, hwc, ties):
    h, w, c = hwc
    feat, boxes, valid, rs = _inputs(device, h, w, c, 37, g_dtype, ties=ties)
    g, pos, rs_t, win = _backward_inputs(feat, boxes, valid, rs, g_dtype)
    for scale in (None, rs_t):
        _assert_backward_exact(g, pos, scale, win, valid, h, w)
    ones = torch.ones_like(g)
    assert torch.equal(bwd_kernel.roi_pool_bwd_cuda(ones, pos, None, *win, valid, h, w).cpu(),
                       roi_pool_backward_reference(ones.cpu(), pos.cpu(), None, h, w))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", [(87, 119, 512), (152, 204, 512), (152, 256, 512),
                                 (87, 119, 1), (87, 119, 3), (87, 119, 200)])
def test_backward_kernel_bit_identical_at_real_shapes(device, g_dtype, hwc):
    """P = 4096 slots (4000 live) of the main path's inputs on the inference
    map (87x119), the top training map (152x204) and the largest VOC
    training map (152x256); 512 channels and the ragged slices of 1, 3 and
    200; with and without scale; two launches alike."""
    h, w, c = hwc
    feat32, boxes, valid, rs = production_pool_inputs(device, hwc)
    g, pos, rs_t, win = _backward_inputs(feat32.to(g_dtype), boxes, valid, rs, g_dtype)
    for scale in (rs_t, None):
        _assert_backward_exact(g, pos, scale, win, valid, h, w)


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_on_misaligned_rows(device, g_dtype):
    """g and pos that do not start on 16 bytes (views one element into their
    storage): each lane loads its own elements, so the kernel needs no
    alignment."""
    h, w, c = 20, 33, 64
    feat, boxes, valid, rs = _inputs(device, h, w, c, 37, g_dtype, ties=True)
    g, pos, rs_t, win = _backward_inputs(feat, boxes, valid, rs, g_dtype)
    g_s = torch.cat([g.new_zeros(1), g.flatten()])[1:].view(g.shape)
    pos_s = torch.cat([pos.new_zeros(1), pos.flatten()])[1:].view(pos.shape)
    assert g_s.data_ptr() % 16 != 0 and pos_s.data_ptr() % 16 != 0 and g_s.is_contiguous()
    _assert_backward_exact(g_s, pos_s, rs_t, win, valid, h, w)


def test_backward_kernel_config_is_the_plan(device):
    """The built library's tile, slice, threads and shared memory are the
    constants the CPU plan test checks."""
    plan = bwd_kernel.launch_plan(87, 119, 512)
    assert bwd_kernel.library_config() == {k: plan[k] for k in
                                           ("tile", "slice", "threads", "smem_bytes")}


def test_backward_kernel_empty_and_rejects(device):
    g = torch.zeros((0, 7, 7, 16), device=device)
    pos = torch.zeros((0, 7, 7, 16), dtype=torch.int32, device=device)
    win0 = [torch.zeros((0, 7), dtype=torch.int32, device=device) for _ in range(4)]
    valid0 = torch.zeros(0, dtype=torch.bool, device=device)
    before = bwd_kernel.launches
    acc = bwd_kernel.roi_pool_bwd_cuda(g, pos, None, *win0, valid0, 5, 6)
    assert acc.shape == (5, 6, 16) and not acc.any() and bwd_kernel.launches == before
    g = torch.zeros((2, 7, 7, 16), device=device)
    pos = torch.zeros((2, 7, 7, 16), dtype=torch.int32, device=device)
    win = [torch.zeros((2, 7), dtype=torch.int32, device=device) for _ in range(4)]
    valid = torch.ones(2, dtype=torch.bool, device=device)
    with pytest.raises(ValueError, match="dtype"):
        bwd_kernel.roi_pool_bwd_cuda(g.half(), pos, None, *win, valid, 5, 6)
    with pytest.raises(ValueError, match="pos"):
        bwd_kernel.roi_pool_bwd_cuda(g, pos.new_zeros((2, 7, 7, 8)), None, *win, valid, 5, 6)
    with pytest.raises(ValueError, match="CUDA"):
        bwd_kernel.roi_pool_bwd_cuda(g.cpu(), pos.cpu(), None, *win, valid, 5, 6)
    with pytest.raises(ValueError, match="hs has shape"):
        bwd_kernel.roi_pool_bwd_cuda(g, pos, None, win[0][:, :6], *win[1:], valid, 5, 6)
    with pytest.raises(ValueError, match="we has shape"):
        bwd_kernel.roi_pool_bwd_cuda(g, pos, None, *win[:3], win[3][:1], valid, 5, 6)
    with pytest.raises(ValueError, match="ws has dtype"):
        bwd_kernel.roi_pool_bwd_cuda(g, pos, None, *win[:2], win[2].long(), win[3], valid, 5, 6)
    with pytest.raises(ValueError, match="valid"):
        bwd_kernel.roi_pool_bwd_cuda(g, pos, None, *win, valid.int(), 5, 6)
    with pytest.raises(ValueError, match="index range"):
        bwd_kernel.roi_pool_bwd_cuda(g, pos, None, *win, valid, 70000, 6)
    assert bwd_kernel.launches == before


def test_autograd_goes_through_both_kernels(device):
    """A feature map that needs a gradient runs the forward and backward
    kernels once each, and its bf16 gradient equals the CPU path's bit for
    bit."""
    feat, boxes, valid, rs = _inputs(device, 16, 24, 64, 10, torch.bfloat16)
    g = torch.randn((10, 7, 7, 64), device=device).bfloat16()
    f, fc = feat.clone().requires_grad_(True), feat.cpu().requires_grad_(True)
    fwd0, bwd0 = kernel.launches, bwd_kernel.launches
    roi_pool(f, boxes, valid, rs, spatial_scale=0.125).backward(g)
    assert (kernel.launches, bwd_kernel.launches) == (fwd0 + 1, bwd0 + 1)
    roi_pool(fc, boxes.cpu(), valid.cpu(), rs.cpu(), spatial_scale=0.125).backward(g.cpu())
    assert f.grad.dtype == torch.bfloat16 and f.grad.is_contiguous()
    assert torch.equal(f.grad.cpu().view(torch.int16), fc.grad.view(torch.int16))
