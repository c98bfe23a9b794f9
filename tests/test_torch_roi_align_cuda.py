"""The CUDA multi-level ROIAlign forward (sos_wsod_torch/csrc/roi_align_fwd.cu)
against its plain version, on the card. Marked ``cuda``: skipped where
torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_align_cuda.py -q

The kernel does the plain version's f32 operations in the same order, never
contracted into an FMA, and skips only the +-0 terms of samples outside a
ROI's grid, so on finite maps the outputs are compared with torch.equal (a
-0 equals +0): at the FPN shapes in bf16 and f32 (tools/bench_roi_align.py),
at small shapes through both the 16-byte and the one-channel paths, in
every aligned / sampling mode.
"""
from __future__ import annotations

import pytest
import torch

from sos_wsod_torch.kernels import roi_align as kernel
from sos_wsod_torch.ops.roi_align import roi_align, roi_align_levels_reference
from sos_wsod_torch.tools.bench_roi_align import check, fpn_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain_at_the_fpn_shapes(device, dtype):
    n = kernel.launches
    check(*fpn_inputs(device, dtype, seed=1))
    assert kernel.launches == n + 1


@pytest.mark.parametrize("c", [8, 12, 3, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_equals_plain_small(device, dtype, c):
    """C = 3 and (bf16) 12 take the one-channel path."""
    check(*fpn_inputs(device, dtype, seed=c, p=50, c=c, canvas=(96, 128), image_hw=(90, 120)))


@pytest.mark.parametrize("aligned,sampling", [(True, 0), (False, 0), (True, 2), (False, 3)])
def test_modes(device, aligned, sampling):
    feats, boxes, valid, level, scales = fpn_inputs(device, torch.float32, seed=7, p=64, c=16)
    got = roi_align(feats[1], boxes, valid, spatial_scale=scales[1], sampling_ratio=sampling,
                    aligned=aligned)
    want = roi_align_levels_reference([feats[1]], boxes, valid, torch.zeros_like(level),
                                      [scales[1]], sampling_ratio=sampling, aligned=aligned)
    assert got.shape == (64, 16, 7, 7) and torch.equal(got, want)
    assert not got[~valid].any()


def test_requires_grad_raises(device):
    feat = torch.randn(8, 8, 16, device=device, requires_grad=True)
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device=device)
    with pytest.raises(NotImplementedError, match="training slice"):
        roi_align(feat, boxes, torch.ones(1, dtype=torch.bool, device=device), spatial_scale=0.5)
