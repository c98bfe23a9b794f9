"""The CUDA multi-level ROIAlign forward (sos_wsod_torch/csrc/roi_align_fwd.cu)
against its plain version, on the card. Marked ``cuda``: skipped where
torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_roi_align_cuda.py -q

The kernel does the plain version's f32 operations in the same order, never
contracted into an FMA, and skips only the +-0 terms of samples outside a
ROI's grid, so on finite maps the outputs are compared with torch.equal (a
-0 equals +0): at the FPN shapes in bf16 and f32 (tools/bench_roi_align.py),
at small shapes through both the 16-byte and the one-channel paths, in
every aligned / sampling mode, and on the benchmark's adversarial cases
(whole-map ROIs on p2 and a ratio of 20, which take the direct branch; a
sample cap of 16; long ROIs on a 1344-wide canvas). It is also held equal,
bit for bit, to itself across launches and to the earlier warp-a-bin design
(tests/baselines/roi_align_fwd_warp_per_bin.cu, built beside it).
"""
from __future__ import annotations

import pathlib

import pytest
import torch

from sos_wsod_torch.kernels import build
from sos_wsod_torch.kernels import roi_align as kernel
from sos_wsod_torch.ops.roi_align import roi_align, roi_align_levels_reference
from sos_wsod_torch.tools import bench_roi_align as bench
from sos_wsod_torch.tools.bench_roi_align import check, fpn_inputs

pytestmark = pytest.mark.cuda

EARLIER = pathlib.Path(__file__).parent / "baselines" / "roi_align_fwd_warp_per_bin.cu"
CASES = ("sample_cap 16", "sampling_ratio 2", "sampling_ratio 3", "sampling_ratio 20",
         "aligned False", "C 3", "C 12", "whole map p2", "whole map p2, sample_cap 16",
         "long ROIs, 1344 wide")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adversarial_cases(device, dtype, case):
    args, kw = bench.adversarial_cases(device, dtype)[case]
    check(*args, **kw)


def test_both_branches_are_taken(device):
    """Every FPN ROI is staged; whole-map ROIs on p2, the longest ROIs on a
    1344-wide canvas and a ratio of 20 take the direct branch, the small
    ROIs beside them the staged one."""
    cases = bench.adversarial_cases(device, torch.bfloat16)
    assert bench.bounds(*fpn_inputs(device, torch.bfloat16, seed=0))["direct"] == 0
    for case in ("whole map p2", "long ROIs, 1344 wide"):
        r = bench.bounds(*cases[case][0])
        assert r["staged"] > 0 and r["direct"] > 0
    args, kw = cases["sampling_ratio 20"]
    assert bench.bounds(*args, **kw)["staged"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_launches_give_the_same_bits(device, dtype):
    for args, kw in [(fpn_inputs(device, dtype, seed=2), {}),
                     bench.adversarial_cases(device, dtype)["whole map p2"]]:
        a = kernel.roi_align_fwd_cuda(*args, **kw)
        b = kernel.roi_align_fwd_cuda(*args, **kw)
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_equals_the_earlier_design(device, dtype):
    lib = kernel.bind(build.build("roi_align_fwd_warp_per_bin", EARLIER))
    cases = [(fpn_inputs(device, dtype, seed=3), {})] + [
        bench.adversarial_cases(device, dtype)[k] for k in CASES]
    for args, kw in cases:
        got = kernel.roi_align_fwd_cuda(*args, **kw)
        want = bench.launcher(lib, *args, **kw)
        assert torch.equal(_bits(got), _bits(want))


def test_library_reports_the_plan(device):
    cfg = kernel.library_config()
    assert cfg == {"threads": kernel.THREADS, "slice_bytes": kernel.SLICE_BYTES,
                   "buffer_bytes": kernel.BUFFER_BYTES, "table": kernel.TABLE,
                   "blocks_per_sm": kernel.BLOCKS_PER_SM, "smem_bytes": kernel.smem_bytes(),
                   "slices_per_block": kernel.SLICES_PER_BLOCK, "vec_bytes": kernel.VEC_BYTES}


def test_requires_grad_raises(device):
    feat = torch.randn(8, 8, 16, device=device, requires_grad=True)
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device=device)
    with pytest.raises(NotImplementedError, match="training slice"):
        roi_align(feat, boxes, torch.ones(1, dtype=torch.bool, device=device), spatial_scale=0.5)
