"""ctypes binding of the CUDA row gather (``csrc/gather_rows.cu``), and its
launch plan.

The kernel runs a persistent grid of blocks that claim chunks of ``blk``
consecutive output rows in order from a counter. Each block lands the rows
of a chunk with TMA bulk copies in a ring of shared-memory stages and writes
each stage out with one bulk store. ``plan`` computes the ring (stages, rows a stage, pieces a row
where a row is larger than a stage, shared memory) and the grid from the row
count and width, ``blk`` and the card's SM count; the source trusts it, so
the CPU tests check it (``tests/test_torch_gather_plan.py``). The tuning
constants below are its defaults.

The wrapper validates its inputs, allocates the output with ``torch.empty``
and launches on PyTorch's current stream. It raises on anything the kernel
does not take and when the launch reports an error; it never falls back to
the plain version. ``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .build import build
from .roi_align import SM_SMEM, SMEM_LIMIT

launches = 0

DTYPES = (torch.bfloat16, torch.float16, torch.float32)
INDEX_BITS = {torch.int32: 32, torch.int64: 64}
DEFAULT_BLK = 32

# the ring's tuning constants (tools/bench_gather.py --sweep times others)
STAGE_BYTES = 32768      # a stage at most: R rows of a width, or one piece of a wider row
RING_BYTES = 65536       # the stages of a block together, at most
BLOCKS_PER_SM = 2        # resident blocks an SM, at most
MAX_ROWS_PER_STAGE = 64  # two rows a lane of the loading warp, as in the source
TX_LIMIT = 1 << 20       # an mbarrier phase takes fewer transaction bytes
SLOT_BYTES = 40          # a stage's "full" and "empty" mbarriers and its place in the output


class Plan(NamedTuple):
    stages: int          # S, at least 2
    stage_bytes: int     # one stage's buffer
    rows_per_stage: int  # R whole rows a stage (1 where rows go in pieces)
    piece_bytes: int     # bytes of a piece (the row's where rows go whole)
    pieces: int          # pieces a row, the last one shorter where it does not divide
    smem_bytes: int      # dynamic shared memory a block: the stages, then their slots
    chunks: int          # ceil(rows / blk)
    blocks_per_sm: int
    grid: int            # min(chunks, SMs x blocks_per_sm)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(rows: int, row_bytes: int, blk: int, sms: int, occupancy: Optional[int] = None, *,
         stage_bytes: int = STAGE_BYTES, ring_bytes: int = RING_BYTES,
         blocks_per_sm: int = BLOCKS_PER_SM) -> Plan:
    """The launch plan for ``rows`` output rows of ``row_bytes`` (a positive
    multiple of 16), ``blk`` rows a chunk, on a card of ``sms`` SMs.
    ``occupancy`` is the blocks an SM holds at the plan's shared memory, as
    the CUDA runtime reports it; without it, the shared memory alone bounds
    the residency. The keywords are the tuning constants."""
    if row_bytes <= 0 or row_bytes % 16 or blk < 1 or sms < 1 or rows < 0:
        raise ValueError(f"gather plan: rows {rows}, row_bytes {row_bytes}, blk {blk}, "
                         f"sms {sms} out of range")
    if not 16 <= stage_bytes < TX_LIMIT or stage_bytes % 16:
        raise ValueError(f"gather plan: a stage of {stage_bytes} bytes")
    if row_bytes <= stage_bytes:
        r = min(MAX_ROWS_PER_STAGE, stage_bytes // row_bytes)
        piece, pieces, stage = row_bytes, 1, r * row_bytes
    else:   # pieces of at most stage_bytes, of multiples of 16, the last one shorter
        piece = _ceil(_ceil(row_bytes, _ceil(row_bytes, stage_bytes)), 16) * 16
        r, pieces, stage = 1, _ceil(row_bytes, piece), piece
    stages = max(2, ring_bytes // stage)
    smem = stages * (stage + SLOT_BYTES)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gather plan: a ring of {smem} bytes exceeds a block's {SMEM_LIMIT}")
    resident = min(blocks_per_sm, SM_SMEM // (smem + 1024))
    if occupancy is not None:
        resident = min(resident, occupancy)
    chunks = _ceil(rows, blk)
    return Plan(stages, stage, r, piece, pieces, smem, chunks, max(1, resident),
                min(chunks, sms * max(1, resident)))


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with this kernel's C interface
    (``sos_gather_rows`` with its plan, ``sos_gather_rows_limits``) and
    declare its argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sos_gather_rows.argtypes = [vp, vp, ci, cl, ci, cl, vp, vp, vp] + [ci] * 7
    lib.sos_gather_rows.restype = ci
    pi = ctypes.POINTER(ci)
    lib.sos_gather_rows_limits.argtypes = [ci, ci, pi, pi]
    lib.sos_gather_rows_limits.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("gather_rows"))


@functools.lru_cache(maxsize=None)
def _limits(lib: ctypes.CDLL, device: int, index_bits: int, smem: int) -> Tuple[int, int]:
    sms, occupancy = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.sos_gather_rows_limits(index_bits, smem, ctypes.byref(sms),
                                         ctypes.byref(occupancy))
    if err != 0 or occupancy.value < 1:
        raise RuntimeError(f"gather_rows_cuda: no block fits an SM at {smem} bytes of shared "
                           f"memory (CUDA error {err})")
    return sms.value, occupancy.value


@functools.lru_cache(maxsize=None)
def _work(device: int, stream: int) -> Tuple[torch.Tensor, torch.cuda.Stream]:
    """The kernel's chunk counter for launches on this stream: two zeroed
    64-bit words, which every launch leaves zeroed. Launches on one stream
    run one after another, so they can share it; the stream is held, so its
    handle is not reused while the counter lives."""
    return (torch.zeros(2, dtype=torch.int64, device=device),
            torch.cuda.current_stream(device))


def device_plan(lib: ctypes.CDLL, table: torch.Tensor, idx: torch.Tensor, blk: int,
                **tuning) -> Plan:
    """``plan`` for these tensors on their card, its SM count and the
    occupancy the runtime reports for ``lib``'s kernel."""
    row_bytes = table.shape[1] * table.element_size()
    smem = plan(1, row_bytes, 1, 1, **tuning).smem_bytes
    sms, occupancy = _limits(lib, table.device.index, INDEX_BITS[idx.dtype], smem)
    return plan(idx.shape[0], row_bytes, blk, sms, occupancy, **tuning)


def launch(lib: ctypes.CDLL, table: torch.Tensor, idx: torch.Tensor, blk: int,
           out: torch.Tensor, p: Plan) -> None:
    """Launch ``lib``'s kernel with plan ``p`` on PyTorch's current stream
    into ``out``; the arguments are those the wrapper has checked. Raises
    when the launch reports an error."""
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        work = _work(table.device.index, stream)[0]
        err = lib.sos_gather_rows(
            table.data_ptr(), idx.data_ptr(), INDEX_BITS[idx.dtype], idx.shape[0],
            table.shape[1] * table.element_size(), blk, out.data_ptr(), stream,
            work.data_ptr(), p.stages, p.stage_bytes, p.rows_per_stage, p.piece_bytes,
            p.pieces, p.smem_bytes, p.grid)
    if err != 0:
        raise RuntimeError(f"gather_rows_cuda: kernel launch failed with CUDA error {err}")


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor,
                     blk: int = DEFAULT_BLK) -> torch.Tensor:
    """Launch the kernel. table (N, C) bfloat16, float16 or float32 and idx
    (R,) int32 or int64 on one CUDA device, contiguous, with rows of a
    multiple of 16 bytes; ``blk`` output rows a chunk. Returns (R, C) in
    the table's dtype. Indices must lie in [0, N): they are not checked
    (that would cost a device sync) and not clamped."""
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
    launch(lib, table, idx, blk, out, device_plan(lib, table, idx, blk))
    launches += 1
    return out
