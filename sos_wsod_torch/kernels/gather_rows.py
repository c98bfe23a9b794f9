"""ctypes binding of the CUDA row gather (``csrc/gather_rows.cu``).

The wrapper validates its inputs, allocates the output with ``torch.empty``
and launches on PyTorch's current stream. It raises on anything the kernel
does not take and when the launch reports an error; it never falls back to
the plain version. ``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import build

launches = 0

DTYPES = (torch.bfloat16, torch.float16, torch.float32)
INDEX_BITS = {torch.int32: 32, torch.int64: 64}
DEFAULT_BLK = 512


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("gather_rows")))
    fn = lib.sos_gather_rows
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [vp, vp, ci, cl, ci, cl, vp, vp]
    fn.restype = ci
    return lib


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor,
                     blk: int = DEFAULT_BLK) -> torch.Tensor:
    """Launch the kernel. table (N, C) bfloat16, float16 or float32 and idx
    (R,) int32 or int64 on one CUDA device, contiguous, with rows of a
    multiple of 16 bytes; ``blk`` output rows per CUDA block. Returns
    (R, C) in the table's dtype. Indices must lie in [0, N): they are not
    checked (that would cost a device sync) and not clamped."""
    global launches
    fn = "gather_rows_cuda"
    if not table.is_cuda:
        raise ValueError(f"{fn}: table must be a CUDA tensor, got {table.device}")
    if table.dtype not in DTYPES:
        raise ValueError(f"{fn}: unsupported table dtype {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"{fn}: table must be a contiguous (N, C) tensor")
    if idx.device != table.device:
        raise ValueError(f"{fn}: idx is on {idx.device}, expected {table.device}")
    if idx.dtype not in INDEX_BITS:
        raise ValueError(f"{fn}: idx has dtype {idx.dtype}, expected int32 or int64")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{fn}: idx must be a contiguous (R,) tensor")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{fn}: rows must be a multiple of 16 bytes at 16-byte aligned "
                         f"addresses, got {row_bytes} bytes a row")
    if row_bytes >= 2**31 or blk < 1:
        raise ValueError(f"{fn}: row of {row_bytes} bytes or blk {blk} out of range")

    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.sos_gather_rows(table.data_ptr(), idx.data_ptr(), INDEX_BITS[idx.dtype],
                                  idx.shape[0], row_bytes, blk, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
