"""The CUDA row gather (sos_wsod_torch/csrc/gather_rows.cu) against its plain
version, index_select, on the card. Marked ``cuda``: skipped where
torch.cuda.is_available() is false. On the card:

    python -m pytest tests/test_torch_gather_cuda.py -q

A gather copies values, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from sos_wsod_torch.kernels import gather_rows as kernel
from sos_wsod_torch.ops.gather import gather_rows, gather_rows_reference
from sos_wsod_torch.tools.bench_gather import check, make_inputs

pytestmark = pytest.mark.cuda

TABLE_ROWS = 2871180


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,dtype", [(1 << 20, torch.bfloat16), ((1 << 20) - 37, torch.bfloat16),
                                        (1 << 18, torch.float32)])
def test_kernel_bit_identical_at_the_smoke_shapes(device, rows, dtype):
    table, idx = make_inputs(TABLE_ROWS, rows, 512, dtype, device, seed=rows)
    assert check(table, idx, 512) == 0.0


@pytest.mark.parametrize("blk", [1, 3, 64, 4096])
@pytest.mark.parametrize("c,dtype", [(8, torch.bfloat16), (24, torch.float16), (4, torch.float32),
                                     (1000, torch.float32)])
def test_kernel_small_shapes_and_int64(device, blk, c, dtype):
    table, idx = make_inputs(517, 333, c, dtype, device, seed=c)
    before = kernel.launches
    for i in (idx, idx.long()):
        out = gather_rows(table, i, blk)
        torch.cuda.synchronize()
        assert torch.equal(out, gather_rows_reference(table, i))
    assert kernel.launches == before + 2
    empty = gather_rows(table, idx[:0], blk)
    assert empty.shape == (0, c) and kernel.launches == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    table, idx = make_inputs(64, 10, 20, torch.bfloat16, device)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        kernel.gather_rows_cuda(table, idx)          # 40-byte rows
    table, idx = make_inputs(64, 10, 16, torch.bfloat16, device)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gather_rows_cuda(table.double(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gather_rows_cuda(table.t(), idx)
    with pytest.raises(ValueError, match="on cpu"):
        kernel.gather_rows_cuda(table, idx.cpu())
    with pytest.raises(ValueError, match="int32 or int64"):
        kernel.gather_rows_cuda(table, idx.short())
