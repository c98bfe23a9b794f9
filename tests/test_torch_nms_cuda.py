"""The CUDA greedy NMS (sos_wsod_torch/csrc/nms.cu) against its plain
version, on the card. Marked ``cuda``: skipped where torch.cuda.is_available()
is false. On the card:

    python -m pytest tests/test_torch_nms_cuda.py -q

The kernels compute each IoU with the plain version's f32 operations, never
contracted into an FMA, so the keep masks are compared bit for bit: at small
and ragged sizes, at the four shapes the port runs (tools/bench_nms.py:
SHAPES), on the reference golden, and through nms_mask and batched_nms_mask
against the same functions run on the CPU.
"""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from sos_wsod_torch.kernels import nms as kernel
from sos_wsod_torch.ops.nms import batched_nms_mask, nms_mask
from sos_wsod_torch.tools.bench_nms import SHAPES, check, nms_case, sorted_inputs

pytestmark = pytest.mark.cuda
GOLD = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(device, batch, s, thr, seed):
    return [torch.from_numpy(a).to(device) for a in nms_case(batch, s, thr, seed)]


@pytest.mark.parametrize("batch,s,thr", [(1, 1, 0.5), (2, 63, 0.3), (3, 64, 0.7), (2, 65, 0.01),
                                         (4, 300, 0.5), (1, 2049, 0.7)])
def test_kernels_match_plain_small(device, batch, s, thr):
    boxes, scores, valid = _case(device, batch, s, thr, seed=s)
    b, v = sorted_inputs(boxes, scores, valid)
    check(b, v, thr)


@pytest.mark.parametrize("name", list(SHAPES))
def test_kernels_match_plain_at_the_real_shapes(device, name):
    batch, s, thr = SHAPES[name]
    boxes, scores, valid = _case(device, batch, s, thr, seed=1)
    b, v = sorted_inputs(boxes, scores, valid)
    m0, s0 = kernel.mask_launches, kernel.sweep_launches
    assert check(b, v, thr) > 0
    assert (kernel.mask_launches - m0, kernel.sweep_launches - s0) == (1, 1)


def test_nms_mask_and_batched_match_cpu(device):
    """The whole op (sort, kernels, scatter) on the card equals the plain
    version on the CPU."""
    boxes, scores, valid = nms_case(20, 500, 0.5, seed=2)
    want = nms_mask(*(torch.from_numpy(a) for a in (boxes, scores, valid)), 0.5)
    got = nms_mask(*(torch.from_numpy(a).to(device) for a in (boxes, scores, valid)), 0.5)
    assert torch.equal(got.cpu(), want)
    idxs = torch.from_numpy(np.random.default_rng(0).integers(0, 5, 500).astype(np.int32))
    args = [torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), idxs,
            torch.from_numpy(valid[0])]
    want = batched_nms_mask(*args, 0.7)
    got = batched_nms_mask(*(a.to(device) for a in args), 0.7)
    assert torch.equal(got.cpu(), want)


def test_reference_golden(device):
    z = np.load(GOLD / "nms.npz")
    d = z["dets0"]
    xyxy = np.stack([d[:, 0] - d[:, 2] / 2, d[:, 1] - d[:, 3] / 2,
                     d[:, 0] + d[:, 2] / 2, d[:, 1] + d[:, 3] / 2], 1).astype(np.float32)
    valid = torch.ones(len(d), dtype=torch.bool, device=device)
    for thr in (0.3, 0.5, 0.7):
        keep = nms_mask(torch.from_numpy(xyxy).to(device),
                        torch.from_numpy(z["scores"]).to(device), valid, thr)
        assert set(torch.nonzero(keep).flatten().tolist()) == set(
            z["keep0_%d" % int(thr * 100)].tolist())


def test_empty_and_refused(device):
    assert kernel.nms_keep_sorted_cuda(torch.zeros(2, 0, 4, device=device),
                                       torch.zeros(2, 0, dtype=torch.bool, device=device),
                                       0.5).shape == (2, 0)
    with pytest.raises(ValueError, match="float32"):
        kernel.nms_mask_words_cuda(torch.zeros(1, 8, 4, device=device, dtype=torch.float64), 0.5)
