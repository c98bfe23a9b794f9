"""Microbenchmark: the hand-written CUDA row gather against ``index_select``.

Counterpart of ``tools/bench_pallas_gather.py`` (the Pallas row-DMA gather
against XLA's ``jnp.take``), with the same flags and shape: 2^20 random rows
of 512 bf16 (1 KB each) from a 2,871,180-row table (2.94 GB), the stage-1
pool forward's gather as the XLA ROIPool formulation runs it. ``--blk`` is
the kernel's output rows per CUDA block. Table and indices are made on the
card from a seeded ``torch.Generator``. The kernel must equal
``index_select`` bit for bit; then both are timed by CUDA events, and each
line gives the median time of one call and the rate under the JAX tool's
yardstick, rows x c x itemsize bytes over that time. ``--turns N`` then
times the two N more rounds in turns (index_select, kernel, kernel,
index_select), each reading a median of ``--iters`` calls, and prints the
range of each: the readings to compare the two by, since the card's
readings move between processes and over time:

    python -m sos_wsod_torch.tools.bench_gather [--rows 1048576] [--blk 512] [--turns 4]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from ..ops.gather import gather_rows, gather_rows_reference
from .measure import cuda_ms


def make_inputs(table_rows: int, rows: int, c: int, dtype: torch.dtype, device,
                seed: int = 0):
    """A (table_rows, c) standard-normal table and (rows,) int32 indices
    drawn uniformly from its rows, both made on ``device`` from ``seed``."""
    g = torch.Generator(device).manual_seed(seed)
    table = torch.randn((table_rows, c), generator=g, device=device, dtype=dtype)
    idx = torch.randint(0, table_rows, (rows,), generator=g, device=device, dtype=torch.int32)
    return table, idx


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def check(table: torch.Tensor, idx: torch.Tensor, blk: int) -> float:
    """Raise unless the kernel's gather equals ``index_select`` bit for bit;
    returns the largest absolute difference (0.0)."""
    out_k = gather_rows(table, idx, blk)
    out_p = gather_rows_reference(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(_bits(out_k), _bits(out_p)):
        bad = (_bits(out_k) != _bits(out_p)).any(1).nonzero()[:5, 0].tolist()
        raise AssertionError(f"cuda_gather differs from index_select in rows {bad} (first 5)")
    return float((out_k.float() - out_p.float()).abs().max())


def run(table: torch.Tensor, idx: torch.Tensor, blk: int, iters: int) -> Dict[str, float]:
    """Check the kernel against ``index_select``, then time both: median ms
    of one call and GB/s of gathered bytes, with the check's max |d|."""
    err = check(table, idx, blk)
    plain_ms = cuda_ms(lambda: gather_rows_reference(table, idx), iters)
    ms = cuda_ms(lambda: gather_rows(table, idx, blk), iters)
    gbytes = idx.shape[0] * table.shape[1] * table.element_size() / 1e9
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "gbs": gbytes / ms * 1e3,
            "plain_gbs": gbytes / plain_ms * 1e3}


def turns(table: torch.Tensor, idx: torch.Tensor, blk: int, iters: int, rounds: int
          ) -> Dict[str, list]:
    """``rounds`` rounds of index_select, kernel, kernel, index_select, each
    a median ms of ``iters`` calls: {"plain_ms": [...], "ms": [...]}."""
    out = {"plain_ms": [], "ms": []}
    plain = ("plain_ms", lambda: gather_rows_reference(table, idx))
    kernel = ("ms", lambda: gather_rows(table, idx, blk))
    for _ in range(rounds):
        for key, fn in (plain, kernel, kernel, plain):
            out[key].append(cuda_ms(fn, iters))
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)  # gathered rows
    ap.add_argument("--table-rows", type=int, default=2871180)
    ap.add_argument("--c", type=int, default=512)
    ap.add_argument("--blk", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--turns", type=int, default=0, help="rounds timed in turns after the check")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather needs a CUDA device")
    device = torch.device("cuda", 0)
    table, idx = make_inputs(args.table_rows, args.rows, args.c, torch.bfloat16, device)
    res = run(table, idx, args.blk, args.iters)
    print(f"index_select  {res['plain_ms']:8.3f} ms  {res['plain_gbs']:7.1f} GB/s", flush=True)
    print(f"cuda_gather   {res['ms']:8.3f} ms  {res['gbs']:7.1f} GB/s (blk={args.blk})",
          flush=True)
    if args.turns:
        t = turns(table, idx, args.blk, args.iters, args.turns)
        for key, name in (("plain_ms", "index_select"), ("ms", "cuda_gather ")):
            print(f"turns {name} {min(t[key]):.3f}-{max(t[key]):.3f} ms over {len(t[key])} "
                  f"readings: {' '.join(f'{x:.3f}' for x in t[key])}", flush=True)
        res["turns"] = t
    return res


if __name__ == "__main__":
    main()
