"""The launch plan of the CUDA row gather (sos_wsod_torch/kernels/gather_rows.py:
plan), which the kernel (csrc/gather_rows.cu) takes as it is given, checked
on the CPU with the kernel's walk emulated in numpy.

The kernel's grid of persistent blocks claims chunks of blk output rows
from a counter; a chunk goes through the ring in stages of R whole rows, or,
where a row is larger than a stage, of one piece of a row (``unit_of`` in
the source). Over row widths from 16 bytes to 64 KB, row counts from 1 to
2^20, blk from 1 to 4096 and cards of 1 and 132 SMs, every output byte is
written by exactly one stage, every copy is a multiple of 16 bytes at a
16-byte offset (in the row, the output and the stage's buffer), a stage
fits its buffer and an mbarrier phase's 2^20 transaction bytes, the ring
fits a block's shared memory and the grid never exceeds the chunks.
"""
from __future__ import annotations

import numpy as np
import pytest

from sos_wsod_torch.kernels import gather_rows as kernel

WIDTHS = (16, 48, 112, 1024, 2048, 4080, 16384, 16400, 40976, 65536)
ROWS = (1, 37, (1 << 20) - 37, 1 << 20)
BLKS = (1, 3, 64, 512, 4096)


def chunk_stages(p: kernel.Plan, n: int, row_bytes: int):
    """The stages of a chunk of ``n`` rows as the kernel walks them: for each
    stage, its first row in the chunk, the rows it holds, the byte offset in
    the row and the bytes a row (``units_of`` / ``unit_of`` in the source)."""
    if p.pieces == 1:
        u = np.arange(-(-n // p.rows_per_stage), dtype=np.int64)
        row = u * p.rows_per_stage
        return row, np.minimum(p.rows_per_stage, n - row), np.zeros_like(u), \
            np.full_like(u, row_bytes)
    u = np.arange(n * p.pieces, dtype=np.int64)
    offset = (u % p.pieces) * p.piece_bytes
    return u // p.pieces, np.ones_like(u), offset, np.minimum(p.piece_bytes, row_bytes - offset)


def check_chunk(p: kernel.Plan, n: int, row_bytes: int) -> None:
    """Every byte of a chunk of ``n`` rows written once, by legal copies."""
    row, count, offset, nbytes = chunk_stages(p, n, row_bytes)
    assert (count >= 1).all() and (count <= p.rows_per_stage).all()
    assert p.rows_per_stage <= 64
    assert (nbytes > 0).all() and (nbytes % 16 == 0).all() and (offset % 16 == 0).all()
    stage = count * nbytes
    assert (stage <= p.stage_bytes).all() and (stage < kernel.TX_LIMIT).all()
    # the stage's output bytes: a contiguous span, the stages tile the chunk
    start = row * row_bytes + offset
    assert start[0] == 0 and (start[1:] == (start + stage)[:-1]).all()
    assert start[-1] + stage[-1] == n * row_bytes
    # each stage's rows lie in the chunk; each row's bytes land at lane * bytes
    assert (row + count <= n).all()
    assert (offset + nbytes <= row_bytes).all()


@pytest.mark.parametrize("row_bytes", WIDTHS)
def test_plan_covers_every_byte_once(row_bytes):
    for sms in (1, 132):
        for rows in ROWS:
            for blk in BLKS:
                p = kernel.plan(rows, row_bytes, blk, sms)
                assert p.stages >= 2 and p.stage_bytes % 16 == 0 and p.piece_bytes % 16 == 0
                assert p.smem_bytes == p.stages * (p.stage_bytes + kernel.SLOT_BYTES)
                assert p.smem_bytes <= 232448
                assert p.chunks == -(-rows // blk) and 1 <= p.grid <= p.chunks
                assert p.grid <= sms * p.blocks_per_sm
                assert p.blocks_per_sm * (p.smem_bytes + 1024) <= kernel.SM_SMEM
                if p.pieces == 1:
                    assert p.piece_bytes == row_bytes
                    assert p.stage_bytes == p.rows_per_stage * row_bytes
                else:
                    assert p.rows_per_stage == 1 and row_bytes > kernel.STAGE_BYTES
                    assert (p.pieces - 1) * p.piece_bytes < row_bytes <= p.pieces * p.piece_bytes
                # the two chunk lengths there are: blk rows, and the last chunk's
                for n in {min(blk, rows), rows - (p.chunks - 1) * blk}:
                    check_chunk(p, n, row_bytes)


def test_plan_at_the_default_shape():
    """2^20 rows of 1 KB and 2^18 of 2 KB on an H100's 132 SMs: whole rows,
    32 and 16 a stage, 2 stages of 32 KB, two blocks an SM."""
    p = kernel.plan(1 << 20, 1024, kernel.DEFAULT_BLK, 132)
    assert p == kernel.Plan(stages=2, stage_bytes=32768, rows_per_stage=32, piece_bytes=1024,
                            pieces=1, smem_bytes=65616, chunks=32768, blocks_per_sm=2, grid=264)
    p = kernel.plan(1 << 18, 2048, kernel.DEFAULT_BLK, 132)
    assert (p.rows_per_stage, p.stage_bytes, p.chunks, p.grid) == (16, 32768, 8192, 264)
    # the runtime's occupancy bounds the residency; a 64 KB row goes in 2 pieces
    assert kernel.plan(1 << 20, 1024, 512, 132, occupancy=1).grid == 132
    p = kernel.plan(10, 65536, 1, 132)
    assert (p.pieces, p.piece_bytes, p.rows_per_stage, p.grid) == (2, 32768, 1, 10)
    # a chunk smaller than a stage, and the last chunk's ragged stage
    p = kernel.plan(1000, 1024, 3, 132)
    assert (p.rows_per_stage, p.chunks, p.grid) == (32, 334, 264)
    row, count, _, _ = chunk_stages(p, 1000 - 333 * 3, 1024)
    assert row.tolist() == [0] and count.tolist() == [1]


def test_plan_rejects_what_the_kernel_does_not_take():
    for args in ((10, 40, 1, 132), (10, 0, 1, 132), (10, 1024, 0, 132), (10, 1024, 1, 0)):
        with pytest.raises(ValueError, match="gather plan"):
            kernel.plan(*args)
    with pytest.raises(ValueError, match="a stage of"):
        kernel.plan(10, 1024, 1, 132, stage_bytes=1 << 20)
    with pytest.raises(ValueError, match="exceeds"):
        kernel.plan(10, 1 << 19, 1, 132, stage_bytes=(1 << 20) - 16)
