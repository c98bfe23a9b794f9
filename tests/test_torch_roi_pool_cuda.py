"""The CUDA ROIPool kernel (sos_wsod_torch/csrc/roi_pool_fwd.cu) against its
plain PyTorch version, on the card. Marked ``cuda``: skipped where
torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_pool_cuda.py -q

Max pooling selects an input value and the scale multiply is one rounding of
an exact product, so kernel and plain version must agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from sos_wsod_torch.kernels import roi_pool as kernel
from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool, roi_pool_reference

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
