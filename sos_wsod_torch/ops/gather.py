"""Row gather: ``out[i, :] = table[idx[i], :]``.

Counterpart of the Pallas row gather of ``tools/bench_pallas_gather.py``
(``make_pallas_gather``), which copies one table row per DMA. A CPU tensor
takes the plain version, ``gather_rows_reference``; a CUDA tensor launches
the hand-written kernel (``kernels/gather_rows.py``) or raises.
"""
from __future__ import annotations

import torch

from ..kernels.gather_rows import DEFAULT_BLK, gather_rows_cuda


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``index_select`` along the rows."""
    return torch.index_select(table, 0, idx.long())


def gather_rows(table: torch.Tensor, idx: torch.Tensor, blk: int = DEFAULT_BLK) -> torch.Tensor:
    """table (N, C), idx (R,) int32 or int64 -> (R, C) in the table's dtype.
    ``blk`` is the kernel's output rows per CUDA block; the plain version
    does not read it."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: expected table (N, C) and idx (R,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"gather_rows: idx has dtype {idx.dtype}, expected int32 or int64")
    if table.is_cuda:
        return gather_rows_cuda(table, idx, blk)
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    raise ValueError(f"gather_rows: no implementation for device {table.device}")
