"""Microbenchmark: the ROIPool kernels at the stage-1 shapes.

    python -m sos_wsod_torch.tools.bench_roi_pool [--kernel fwd|bwd|both]
        [--baseline LABEL=OLD_FWD.cu ...] [--bwd-baseline LABEL=OLD_BWD.cu ...]
        [--sweep] [--iters 20]

The inputs are the main path's at full width (``production_pool_inputs``):
random plain5-sized features with a tie plateau, 4000 proposals padded to
4096 slots with whole-image, sub-cell, corner and sliver boxes, and
objectness scales in [1, 2]. Cases: the 87x119x512 inference canvas in bf16
and f32 and the 152x204x512 top training map in bf16.

Forward: each case with pos (the training call) and without (the inference
call). Every library is first held bit-identical to the plain version, out
and pos, at each shape and dtype.

Backward: the cotangent is random (bf16 or f32, from a seed) on the current
forward kernel's argmax, with the scales. Every build with the current C
interface is held bit-identical to the plain version run on the CPU and to
itself across two launches; a build with the earlier interface (the f32
atomics: no windows, a zeroed accumulator), run through a small adapter
here, only within the atomics' rounding bound. ``--sweep`` adds builds of
the current source with other tile and warp constants (``SWEEP``).

Each case is then timed by CUDA events (median of ``--iters`` calls) in
turns over the libraries: the baseline builds (other sources with the same
C interface, e.g. earlier versions of it), the current source, then the same
in reverse. Each line gives the times beside the bound, the bytes the
function must move (each input read once, each output written once) over
the H100's 3.35 TB/s of HBM; the forward's line adds the rate at which it
reads its windows' cells (from L2), the backward's the bin-tile pairs it
visits, the bytes it reads for them and the time of ``index_add_`` alone on
precomputed flat indices.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import re
import statistics
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import roi_pool as kernel
from ..kernels import roi_pool_bwd as bwd_kernel
from ..ops.roi_pool import bin_windows, roi_pool_backward_reference, roi_pool_reference
from .measure import bound_ms, card_line, cuda_ms

FEAT_HWC = (87, 119, 512)      # plain5 of a 688x917 image on its 704x960 canvas
TOP_FEAT_HWC = (152, 204, 512)  # plain5 at the top training scale, 1216 x ~1621
NUM_PROPOSALS, CAPACITY = 4000, 4096
CASES = ((FEAT_HWC, torch.bfloat16), (FEAT_HWC, torch.float32), (TOP_FEAT_HWC, torch.bfloat16))


def production_pool_inputs(device, hwc=FEAT_HWC, seed: int = 0):
    """Random plain5-sized features with a constant tie plateau, 4000 random
    proposals padded to 4096 plus whole-image, sub-cell, corner and sliver
    boxes, and objectness scales in [1, 2]: (feat f32, boxes, valid, rs)."""
    rng = np.random.RandomState(seed)
    h, w, c = hwc
    feat = rng.randn(h, w, c).astype(np.float32)
    feat[10:30, 20:50] = 1.5                          # tie plateau
    img_h, img_w = 8 * h - 8, 8 * w - 35              # 688 x 917 at the production shape
    x1 = rng.uniform(0, img_w - 10, CAPACITY)
    y1 = rng.uniform(0, img_h - 10, CAPACITY)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(2, img_w / 2, CAPACITY), img_w),
                      np.minimum(y1 + rng.uniform(2, img_h / 2, CAPACITY), img_h)], 1)
    boxes[:5] = [[0, 0, img_w, img_h], [5, 5, 6, 6], [img_w - 4, img_h - 4, img_w, img_h],
                 [0, 0, 3, img_h], [160, 80, 400, 240]]   # the last lies on the plateau
    valid = np.arange(CAPACITY) < NUM_PROPOSALS
    rs = rng.uniform(1, 2, CAPACITY).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(feat), t(boxes.astype(np.float32)), t(valid), t(rs)


def fwd_traffic_bytes(h: int, w: int, c: int, p: int, ph: int, pw: int, itemsize: int,
                      with_pos: bool) -> int:
    """Bytes the forward must move: the (h, w, c) map, the int32 windows,
    valid and the f32 scales read once, out (and int32 pos) written once."""
    reads = h * w * c * itemsize + 2 * p * (ph + pw) * 4 + p + 4 * p
    writes = p * ph * pw * c * (itemsize + (4 if with_pos else 0))
    return reads + writes


def bwd_traffic_bytes(h: int, w: int, c: int, p: int, ph: int, pw: int, itemsize: int) -> int:
    """Bytes the backward must move: g and int32 pos (P, PH, PW, C), the f32
    scales, the int32 windows and valid read once, the f32 (h, w, c) map
    written once."""
    return p * ph * pw * c * (itemsize + 4) + 4 * p + 2 * p * (ph + pw) * 4 + p + h * w * c * 4


def window_cells(hs, he, ws, we, valid) -> int:
    """Cells in all live bins' windows: what the kernel reads, per channel."""
    nh = (he - hs).clamp(min=0).long()
    nw = (we - ws).clamp(min=0).long()
    return int(((nh[:, :, None] * nw[:, None, :]) * valid[:, None, None]).sum())


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def pool(lib, feat, win, valid, rs, with_pos: bool):
    """One forward call of ``lib``'s kernel, allocating as the wrapper does."""
    shape = (*win[0].shape, win[2].shape[1], feat.shape[2])
    out = torch.empty(shape, dtype=feat.dtype, device=feat.device)
    pos = torch.empty(shape, dtype=torch.int32, device=feat.device) if with_pos else None
    kernel.launch(lib, feat, *win, valid, rs, out, pos)
    return out, pos


Pool = Callable[..., tuple]   # (feat, win, valid, row_scale, with_pos) -> (out, pos or None)


def check(pools: Dict[str, Pool], feat, win, valid, rs) -> float:
    """Raise unless every pool equals the plain version bit for bit: out
    and pos with scale, out without pos (pos None), and out without scale.
    Returns the largest absolute difference of out (0.0)."""
    out_p, pos_p = roi_pool_reference(feat, *win, valid, rs)
    out_n = roi_pool_reference(feat, *win, valid, None)[0]
    err = 0.0
    for label, fn in pools.items():
        out_k, pos_k = fn(feat, win, valid, rs, True)
        out_i, no_pos = fn(feat, win, valid, rs, False)
        out_s, _ = fn(feat, win, valid, None, False)
        if no_pos is not None:
            raise AssertionError(f"{label}: a call without pos returned one")
        for name, a, b in (("out", out_k, out_p), ("pos", pos_k, pos_p),
                           ("out without pos", out_i, out_p), ("out without scale", out_s, out_n)):
            if not torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(b) if b.is_floating_point() else b):
                raise AssertionError(f"{label}: {name} differs from the plain version in "
                                     f"{int((a != b).sum())} elements, feat {tuple(feat.shape)} "
                                     f"{feat.dtype}")
        err = max(err, float((out_k.float() - out_p.float()).abs().max()))
    return err


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("fwd", "bwd", "both"), default="both")
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH: another source with the forward's C interface")
    ap.add_argument("--bwd-baseline", action="append", default=[],
                    help="LABEL=PATH: another backward source, with the current C interface "
                         "or the earlier one of the f32 atomics")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the backward at other tile sizes and warps a block")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def _turns(fns: Dict[str, Callable[[], object]], iters: int) -> Dict[str, List[float]]:
    """Median ms of each callable, visited in order and then in reverse."""
    labels = list(fns)
    times = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        times[label].append(cuda_ms(fns[label], iters))
    return times


def _fmt(times: Dict[str, List[float]]) -> str:
    return " | ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in v) + " ms"
                      for k, v in times.items())


def bench_fwd(args, device, card: str) -> List[dict]:
    libs = {}
    for spec in args.baseline:
        label, path = spec.split("=", 1)
        libs[label] = kernel.bind(kbuild.build(f"roi_pool_fwd_{label}", path))
    libs["current"] = kernel.bind(kbuild.build("roi_pool_fwd"))
    pools = {label: functools.partial(pool, lib) for label, lib in libs.items()}
    results = []
    for hwc, dtype in CASES:
        feat32, boxes, valid, rs = production_pool_inputs(device, hwc)
        h, w, c = hwc
        feat = feat32.to(dtype)
        win = bin_windows(boxes, valid, h, w, 7, 7, 1.0 / 8)
        check(pools, feat, win, valid, rs)
        window_gb = window_cells(*win, valid) * c * feat.element_size() / 1e9
        for with_pos in (True, False):
            times = _turns({label: functools.partial(fn, feat, win, valid, rs, with_pos)
                            for label, fn in pools.items()}, args.iters)
            nbytes = fwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, feat.element_size(), with_pos)
            bound = bound_ms(nbytes)
            cur = statistics.median(times["current"])
            res = {"kernel": "fwd", "hwc": hwc, "dtype": str(dtype)[6:], "pos": with_pos,
                   "bound_ms": bound, "window_gb": window_gb, "times": times}
            results.append(res)
            print(f"fwd {h}x{w}x{c} {res['dtype']:8s} {'pos' if with_pos else 'no pos':6s} | "
                  f"{_fmt(times)} | bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), current at "
                  f"{100 * bound / cur:.1f}% of it | windows {window_gb:.2f} GB from L2, "
                  f"{window_gb / cur:.2f} TB/s | {card}", flush=True)
    return results


SWEEP = ((8, 8, 2), (8, 8, 8), (4, 8, 4), (8, 16, 4), (16, 8, 4), (16, 16, 2))
# (tile rows, tile columns, warps a block: 32 channels each)


def sweep_source(tile_h: int, tile_w: int, warps: int) -> pathlib.Path:
    """A copy of the current backward source with other tile and warp
    constants, written under build/ for a baseline build."""
    src = (kbuild.CSRC_DIR / "roi_pool_bwd.cu").read_text()
    for name, val in (("kTileH", tile_h), ("kTileW", tile_w), ("kWarps", warps)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};", src)
        if n != 1:
            raise RuntimeError(f"no single constant {name} in roi_pool_bwd.cu")
    out = kbuild.BUILD_DIR / "sweep" / f"roi_pool_bwd_{tile_h}x{tile_w}w{warps}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def _old_interface(path) -> bool:
    """Whether a backward source has the earlier C interface (g, pos, rs,
    P, PH, PW, C, a zeroed accumulator): 10 parameters against 17."""
    m = re.search(r"int sos_roi_pool_bwd\(([^)]*)\)", pathlib.Path(path).read_text())
    return m is not None and m.group(1).count(",") == 9


def _bind_old(path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_roi_pool_bwd.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, vp, vp]
    lib.sos_roi_pool_bwd.restype = ci
    return lib


def _old_bwd(lib, g, pos, rs, hs, he, ws, we, valid, h, w):
    """The adapter: the earlier kernel on a zeroed accumulator."""
    p, ph, pw, c = g.shape
    acc = torch.zeros((h, w, c), dtype=torch.float32, device=g.device)
    err = lib.sos_roi_pool_bwd(kernel.DTYPES[g.dtype], g.data_ptr(), pos.data_ptr(),
                               None if rs is None else rs.data_ptr(), p, ph, pw, c,
                               acc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline backward: CUDA error {err}")
    return acc


def _new_bwd(lib, g, pos, rs, hs, he, ws, we, valid, h, w):
    out = torch.empty((h, w, g.shape[3]), dtype=torch.float32, device=g.device)
    bwd_kernel.launch(lib, g, pos, rs, hs, he, ws, we, valid, out)
    return out


def bwd_builds(args) -> Dict[str, tuple]:
    """label -> (backward callable, exact): the baselines, the sweep's
    variants and the current source."""
    specs = [spec.split("=", 1) for spec in args.bwd_baseline]
    if args.sweep:
        specs += [(f"{th}x{tw}w{wp}", str(sweep_source(th, tw, wp))) for th, tw, wp in SWEEP]
    specs.append(("current", None))
    with ThreadPoolExecutor(len(specs)) as ex:   # one nvcc each, all at once
        paths = list(ex.map(lambda s: kbuild.build(f"roi_pool_bwd_{s[0]}" if s[1] else
                                                   "roi_pool_bwd", s[1]), specs))
    builds = {}
    for (label, src), path in zip(specs, paths):
        if src and _old_interface(src):
            builds[label] = (functools.partial(_old_bwd, _bind_old(path)), False)
        else:
            builds[label] = (functools.partial(_new_bwd, bwd_kernel.bind(path)), True)
    return builds


def bwd_inputs(device, hwc, dtype, seed: int = 0):
    """The backward's main-path inputs: the windows and scales of
    ``production_pool_inputs``, pos from the current forward kernel, a
    random cotangent of ``dtype`` and the scales rounded to it."""
    feat32, boxes, valid, rs = production_pool_inputs(device, hwc, seed)
    h, w, _ = hwc
    win = bin_windows(boxes, valid, h, w, 7, 7, 1.0 / 8)
    _, pos = kernel.roi_pool_fwd_cuda(feat32.to(dtype), *win, valid, rs)
    gen = torch.Generator(device).manual_seed(seed)
    g = torch.randn(pos.shape, generator=gen, device=device).to(dtype)
    return g, pos, rs.to(dtype).float(), win, valid


def check_bwd(builds: Dict[str, tuple], g, pos, rs, win, valid, h, w) -> float:
    """Raise unless every exact build equals the plain version run on the
    CPU bit for bit, and itself across two launches. An earlier (atomic)
    build adds in another order: a cell of n terms whose absolute values sum
    to S must agree within 2 n 2^-24 S. Returns the largest absolute
    difference of an exact build (0.0)."""
    g_c, pos_c, rs_c = g.cpu(), pos.cpu(), rs.cpu()
    want = roi_pool_backward_reference(g_c, pos_c, rs_c, h, w)
    err = 0.0
    for label, (fn, exact) in builds.items():
        a = fn(g, pos, rs, *win, valid, h, w)
        b = fn(g, pos, rs, *win, valid, h, w)
        a_cpu = a.cpu()
        if not exact:
            count = roi_pool_backward_reference(torch.ones_like(g_c), pos_c, None, h, w)
            abs_sum = roi_pool_backward_reference(g_c.abs(), pos_c, rs_c, h, w)
            bad = int(((a_cpu - want).abs() > 2 * count * 2.0 ** -24 * abs_sum).sum())
            if bad:
                raise AssertionError(f"{label}: {bad} cells beyond the atomics' bound")
            continue
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two launches differ in {int((a != b).sum())} "
                                 f"elements, g {tuple(g.shape)} {g.dtype}")
        if not torch.equal(a_cpu.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{label}: differs from the plain version in "
                                 f"{int((a_cpu != want).sum())} elements, g {tuple(g.shape)} "
                                 f"{g.dtype}")
        err = max(err, float((a_cpu - want).abs().max()))
    return err


def index_add_ms(g, pos, rs, h: int, w: int, iters: int) -> float:
    """The library call: one ``index_add_`` on flat indices made beforehand."""
    c = g.shape[3]
    ch = torch.arange(c, dtype=torch.int64, device=g.device)
    flat = torch.where(pos >= 0, pos.long() * c + ch, h * w * c).reshape(-1)
    gp = (g.float() * rs[:, None, None, None]).reshape(-1)
    return cuda_ms(lambda: torch.zeros(h * w * c + 1, device=g.device).index_add_(0, flat, gp),
                   iters)


def bench_bwd(args, device, card: str) -> List[dict]:
    builds = bwd_builds(args)
    results = []
    for hwc, dtype in CASES:
        h, w, c = hwc
        g, pos, rs, win, valid = bwd_inputs(device, hwc, dtype)
        check_bwd(builds, g, pos, rs, win, valid, h, w)
        times = _turns({label: functools.partial(fn, g, pos, rs, *win, valid, h, w)
                        for label, (fn, _) in builds.items()}, args.iters)
        isz = g.element_size()
        nbytes = bwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, isz)
        bound = bound_ms(nbytes)
        pairs = bwd_kernel.tile_incidences(*win, valid)   # of the current build's tiles
        read_gb = pairs * c * (isz + 4) / 1e9
        lib_ms = index_add_ms(g, pos, rs, h, w, args.iters)
        cur = statistics.median(times["current"])
        res = {"kernel": "bwd", "hwc": hwc, "dtype": str(dtype)[6:], "bound_ms": bound,
               "tile_pairs": pairs, "read_gb": read_gb, "library_ms": lib_ms, "times": times}
        results.append(res)
        print(f"bwd {h}x{w}x{c} {res['dtype']:8s} | {_fmt(times)} | bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB), current at {100 * bound / cur:.1f}% of it | "
              f"{pairs} bin-tile pairs, {read_gb:.3f} GB of g and pos read, "
              f"{read_gb / cur:.2f} TB/s | index_add_ {lib_ms:.3f} ms | {card}", flush=True)
        del g, pos
    return results


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_roi_pool needs a CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"{torch.cuda.get_device_name(0)} | {card}", flush=True)
    results = []
    if args.kernel in ("fwd", "both"):
        results += bench_fwd(args, device, card)
    if args.kernel in ("bwd", "both"):
        results += bench_bwd(args, device, card)
    return results


if __name__ == "__main__":
    main()
