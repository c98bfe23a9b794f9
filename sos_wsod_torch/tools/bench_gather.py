"""Microbenchmark: the hand-written CUDA row gather against ``index_select``.

Counterpart of ``tools/bench_pallas_gather.py`` (the Pallas row-DMA gather
against XLA's ``jnp.take``), with the same flags and shape: 2^20 random rows
of 512 bf16 (1 KB each) from a 2,871,180-row table (2.94 GB), the stage-1
pool forward's gather as the XLA ROIPool formulation runs it; ``--dtype
f32`` makes 2 KB rows. ``--blk`` is the kernel's output rows a chunk. Table
and int32 indices are made on the card from a seeded ``torch.Generator``.

Every build must equal ``index_select`` (on the same int32 indices) bit for
bit. Then each is timed by device time alone (``measure.device_ms``: the
median of ``--iters`` calls, the host's enqueue outside the window), in
turns: the baselines, ``index_select``, the current build, then the same in
reverse, ``--turns`` rounds of that. A baseline (``--baseline LABEL=PATH``,
or ``LABEL@BLK=PATH`` to run it at its own blk) is another source with the
kernel's C interface, or with PR 3's (no plan), e.g. an earlier version
written under ``build/``. ``--sweep`` adds the current source under other
ring plans (``SWEEP``), ``--variants`` copies of it with the edits of
``VARIANTS`` (another chunk walk, L2 cache hints). Readings move between
processes: run the module in several to compare builds.

    python -m sos_wsod_torch.tools.bench_gather [--rows 1048576] [--dtype bf16|f32]
        [--blk 32] [--turns 4] [--baseline LABEL=OLD.cu ...] [--sweep] [--variants]
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import re
import statistics
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import torch

from ..kernels import build as kbuild
from ..kernels import gather_rows as kernel
from ..ops.gather import gather_rows, gather_rows_reference
from .measure import (bound_ms, card_line, compiler_report, cuda_ms, device_ms, fmt_turns,
                      in_turns)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (stage bytes, ring bytes, blocks an SM, blk): other plans --sweep times
SWEEP = ((16384, 98304, 2, 512), (32768, 65536, 2, 512), (32768, 65536, 2, 128),
         (16384, 65536, 2, 16), (32768, 65536, 3, 32), (32768, 98304, 2, 32),
         (65536, 131072, 1, 64), (16384, 32768, 4, 16), (16384, 131072, 1, 16),
         (8192, 65536, 2, 8))

Gather = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

# --variants: the design's alternatives, as edits of the current source
_CLAIM = """    for (;;) {
      int64_t c = 0;
      if (lane == 0) c = (int64_t)atomicAdd(&work[0], 1ull);
      c = __shfl_sync(0xffffffffu, c, 0);
      if (c >= chunks) break;
"""
_POLICY = "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;"
_LOAD = "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
VARIANTS = {
    # block b walks chunks b, b + grid, ... instead of claiming them in order
    "stride": ((_CLAIM, "    for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {\n"),),
    # the loads, or the stores, with an L2 evict-first policy
    "load_evict_first": (
        (f'"{_LOAD} [%0], [%1], %2, [%3];"',
         f'"{{ .reg .b64 pol; {_POLICY} {_LOAD}.L2::cache_hint [%0], [%1], %2, [%3], pol; }}"'),),
    "store_evict_first": (
        ('"cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"',
         f'"{{ .reg .b64 pol; {_POLICY} cp.async.bulk.global.shared::cta.bulk_group'
         f'.L2::cache_hint [%0], [%1], %2, pol; }}"'),),
}


def variant_source(name: str) -> pathlib.Path:
    """A copy of the current source with one of ``VARIANTS``' edits,
    written under build/ for a baseline build."""
    src = (kbuild.CSRC_DIR / "gather_rows.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: no single {old[:40]!r} in gather_rows.cu")
        src = src.replace(old, new)
    out = kbuild.BUILD_DIR / "sweep" / f"gather_rows_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def make_inputs(table_rows: int, rows: int, c: int, dtype: torch.dtype, device,
                seed: int = 0):
    """A (table_rows, c) standard-normal table and (rows,) int32 indices
    drawn uniformly from its rows, both made on ``device`` from ``seed``."""
    g = torch.Generator(device).manual_seed(seed)
    table = torch.randn((table_rows, c), generator=g, device=device, dtype=dtype)
    idx = torch.randint(0, table_rows, (rows,), generator=g, device=device, dtype=torch.int32)
    return table, idx


def traffic_bytes(table: torch.Tensor, idx: torch.Tensor) -> int:
    """The rows read once and written once, the indices read once."""
    return 2 * idx.shape[0] * table.shape[1] * table.element_size() + idx.nbytes


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def check(table: torch.Tensor, idx: torch.Tensor, blk: int, fn: Gather = gather_rows) -> float:
    """Raise unless ``fn``'s gather (the wrapper's by default) equals
    ``index_select`` bit for bit; returns the largest absolute difference
    (0.0)."""
    out_k = fn(table, idx, blk)
    out_p = gather_rows_reference(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(_bits(out_k), _bits(out_p)):
        bad = (_bits(out_k) != _bits(out_p)).any(1).nonzero()[:5, 0].tolist()
        raise AssertionError(f"cuda_gather differs from index_select in rows {bad} (first 5)")
    return float((out_k.float() - out_p.float()).abs().max())


def _planned(lib: ctypes.CDLL, tuning: dict, table, idx, blk):
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    kernel.launch(lib, table, idx, blk, out, kernel.device_plan(lib, table, idx, blk, **tuning))
    return out


def _unplanned(lib: ctypes.CDLL, table, idx, blk):
    """PR 3's interface: the eight arguments and no plan."""
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    err = lib.sos_gather_rows(table.data_ptr(), idx.data_ptr(), kernel.INDEX_BITS[idx.dtype],
                              idx.shape[0], table.shape[1] * table.element_size(), blk,
                              out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline gather: CUDA error {err}")
    return out


def _bind(path, src) -> Gather:
    m = re.search(r"int sos_gather_rows\(([^)]*)\)", pathlib.Path(src).read_text())
    if m is None or m.group(1).count(",") != 7:   # not PR 3's eight parameters
        return functools.partial(_planned, kernel.bind(path), {})
    lib = ctypes.CDLL(str(path))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sos_gather_rows.argtypes = [vp, vp, ci, cl, ci, cl, vp, vp]
    lib.sos_gather_rows.restype = ci
    return functools.partial(_unplanned, lib)


def _with_blk(fn: Gather, blk: int) -> Gather:
    return lambda table, idx, _: fn(table, idx, blk)


def builds(baselines: Sequence[str] = (), sweep: bool = False) -> Dict[str, Gather]:
    """label -> gather (table, idx, blk -> out): each LABEL=PATH baseline
    (LABEL@BLK=PATH runs it at that blk in place of the caller's), and with
    ``sweep`` the current source under each plan of ``SWEEP`` (at its blk).
    They launch the libraries directly, so they leave the wrapper's launch
    count alone."""
    specs = [spec.split("=", 1) for spec in baselines]
    with ThreadPoolExecutor(max(1, len(specs))) as ex:   # one nvcc each, all at once
        paths = list(ex.map(lambda s: kbuild.build("gather_rows_" + re.sub(r"\W", "_", s[0]),
                                                   s[1]), specs))
    out = {}
    for (label, src), path in zip(specs, paths):
        fn = _bind(path, src)
        out[label] = _with_blk(fn, int(label.split("@")[1])) if "@" in label else fn
    if sweep:
        lib = kernel.bind(kbuild.build("gather_rows"))
        for stage, ring, blocks, blk in SWEEP:
            tuning = {"stage_bytes": stage, "ring_bytes": ring, "blocks_per_sm": blocks}
            out[f"s{stage // 1024}K_r{ring // 1024}K_b{blocks}_blk{blk}"] = _with_blk(
                functools.partial(_planned, lib, tuning), blk)
    return out


def run(table: torch.Tensor, idx: torch.Tensor, blk: int, iters: int, rounds: int = 1,
        baselines: Sequence[str] = (), sweep: bool = False) -> Dict[str, object]:
    """Check every build against ``index_select``, then time them in turns
    by device time. Returns max_abs_err, ms and plain_ms (the medians of
    the current build's and ``index_select``'s device times), called_ms (the
    current build through the wrapper, the host's enqueue included), bound_ms,
    GB/s of gathered bytes and the turns: {label: [ms, ...]}."""
    err = check(table, idx, blk)
    others = builds(baselines, sweep)
    for fn in others.values():
        check(table, idx, blk, fn)
    fns = {label: functools.partial(fn, table, idx, blk) for label, fn in others.items()}
    fns["index_select"] = lambda: gather_rows_reference(table, idx)
    fns["cuda_gather"] = lambda: gather_rows(table, idx, blk)
    turns = {label: [] for label in fns}
    for _ in range(rounds):
        for label, times in in_turns(fns, iters, device_ms).items():
            turns[label] += times
    ms, plain_ms = (statistics.median(turns[k]) for k in ("cuda_gather", "index_select"))
    gbytes = idx.shape[0] * table.shape[1] * table.element_size() / 1e9
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "called_ms": cuda_ms(fns["cuda_gather"], iters),
            "bound_ms": bound_ms(traffic_bytes(table, idx)), "gbs": gbytes / ms * 1e3,
            "plain_gbs": gbytes / plain_ms * 1e3, "turns": turns}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)  # gathered rows
    ap.add_argument("--table-rows", type=int, default=2871180)
    ap.add_argument("--c", type=int, default=512)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--blk", type=int, default=kernel.DEFAULT_BLK)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--turns", type=int, default=1, help="rounds of timing in turns")
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH or LABEL@BLK=PATH: another source with the kernel's C "
                         "interface or PR 3's, at --blk or at BLK")
    ap.add_argument("--sweep", action="store_true", help="also time the plans of SWEEP")
    ap.add_argument("--variants", action="store_true",
                    help="also time the current source with each edit of VARIANTS")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gather needs a CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    table, idx = make_inputs(args.table_rows, args.rows, args.c, DTYPES[args.dtype], device)
    baselines = list(args.baseline)
    if args.variants:
        baselines += [f"{name}={variant_source(name)}" for name in VARIANTS]
    res = run(table, idx, args.blk, args.iters, args.turns, baselines, args.sweep)
    lib = kbuild.build("gather_rows")
    p = res["plan"] = kernel.device_plan(kernel.bind(lib), table, idx, args.blk)
    print(f"[gather] {args.rows} rows of {args.c} {args.dtype} from {args.table_rows}, blk "
          f"{args.blk}: every build bit-identical to index_select; plan {p._asdict()}; "
          f"{compiler_report(lib)}", flush=True)
    bound = res["bound_ms"]
    print(f"[gather] device ms: cuda_gather {res['ms']:.4f} ({res['gbs']:.1f} GB/s, "
          f"{100 * bound / res['ms']:.1f}% of the bound), index_select {res['plain_ms']:.4f} "
          f"({res['plain_gbs']:.1f} GB/s, {100 * bound / res['plain_ms']:.1f}%); bound "
          f"{bound:.4f} ms; cuda_gather as called {res['called_ms']:.4f} ms | {card}", flush=True)
    print(f"[gather] in turns: {fmt_turns(res['turns'])}", flush=True)
    for label, times in res["turns"].items():
        print(f"[gather] {label:24s} {min(times):.4f}-{max(times):.4f} ms, median "
              f"{statistics.median(times):.4f} ({100 * bound / statistics.median(times):.1f}% "
              f"of the bound)", flush=True)
    return res


if __name__ == "__main__":
    main()
