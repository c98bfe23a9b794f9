"""Kernel E (the ROILoopPool forward, ``csrc/roi_loop_pool_fwd.cu``) against
its plain version, and its time beside the bound, on one CUDA card.

    python -m sos_wsod_torch.tools.bench_roi_loop_pool [--baseline LABEL=OLD.cu ...]
        [--direct] [--iters N]

Cases: the production shape (plain5 of a 688 x 917 image, 87 x 119 x 512,
4000 proposals in 4096 slots) and the top training map (152 x 204 x 512),
each in bf16 and f32; the kernel's staged branch takes all four. Every
build is first held bit-identical to the plain version at each case: out
and pos with scale, out without pos, and out without scale. Then each case
is timed with pos (the training call) and without (the inference call) by
CUDA events (median of ``--iters`` calls), in turns over the builds: the
baselines (other sources with the same C interface, e.g. an earlier version
of the kernel), with ``--direct`` the current source with kTiledMaxW = 0
(every shape on the direct branch), the current source, then the same in
reverse. Readings move by about 8% between processes: run the module in
several processes to compare builds. Each line gives the branch the current
build reports, the bound (the map, boxes, valid and scales read once, out
and pos written once, over the card's HBM rate), the window cells the first
design read and those the current one reads (and how many of them from
shared memory), and the bytes of the map the current one reads from L2 (the
staged branch: its blocks' regions, and the windows larger than a region;
the direct branch: every cell it scans, at C channels).

``run`` (chip_smoke.py phase 4e) checks and times the current build alone at
the production shape in bf16 and f32 and the top training map in bf16 (the
staged branch; the card tests take f32 there), at the production shape in
bf16 on a misaligned map (the direct branch), and on the adversarial map of
``adversarial_inputs`` (a zero block, a negative block, boxes covering the
image, on its edge, below a cell, empty and invalid; 136 channels staged and
3 direct), with the backward (kernel A bwd over the 3P rows) bit-identical
to the plain backward run on the CPU and across two launches at the
production shape and the adversarial map.
"""
from __future__ import annotations

import argparse
import functools
import pathlib
import re
import statistics
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import roi_loop_pool as kernel
from ..kernels.roi_loop_pool import roi_loop_pool_fwd_cuda
from ..kernels.roi_pool_bwd import roi_pool_bwd_cuda
from ..ops.roi_loop_pool import loop_windows, roi_loop_pool_reference
from ..ops.roi_pool import roi_pool_backward_reference
from .bench_roi_pool import FEAT_HWC, TOP_FEAT_HWC, _bits, production_pool_inputs
from .measure import (bound_ms, card_line, compiler_report, cuda_ms, device_ms, fmt_turns,
                      in_turns)

SCALE = 1.0 / 8
CASES = ((FEAT_HWC, torch.bfloat16), (FEAT_HWC, torch.float32),
         (TOP_FEAT_HWC, torch.bfloat16), (TOP_FEAT_HWC, torch.float32))
RUN_CASES = CASES[:3]   # chip_smoke.py phase 4e: the top training map in bf16 only
VEC_BYTES, CELL_VECS = 16, 32   # a lane's channels in bytes; a staged cell's 16-byte vectors


def traffic_bytes(h: int, w: int, c: int, p: int, ph: int, pw: int, itemsize: int,
                  with_pos: bool) -> int:
    """Bytes the function must move: the (h, w, c) map, the (P, 4) f32 boxes,
    valid and the f32 scales read once; the 3P rows of out (and int32 pos)
    written once."""
    return h * w * c * itemsize + p * (16 + 1 + 4) + 3 * p * ph * pw * c * (
        itemsize + (4 if with_pos else 0))


def _kept(hs, he, ws, we, ex):
    """Cells of each row's bin windows less those strictly inside the row's
    rectangle: (3P, PH, PW)."""
    nh = (he - hs).clamp(min=0)
    nw = (we - ws).clamp(min=0)
    ih = (torch.minimum(he, ex[:, 1:2]) - torch.maximum(hs, ex[:, 0:1] + 1)).clamp(min=0)
    iw = (torch.minimum(we, ex[:, 3:4]) - torch.maximum(ws, ex[:, 2:3] + 1)).clamp(min=0)
    return nh[:, :, None] * nw[:, None, :] - ih[:, :, None] * iw[:, None, :]


def scan_cells(hs, he, ws, we, ex, valid) -> Dict[str, int]:
    """Window cells of the live bins, per channel: the box rows' windows,
    the frame and context rows' kept cells (their windows less the cells
    strictly inside their rectangles), what the first design read (the
    three) and what the fused scan reads (the box windows and the context
    rows' kept cells)."""
    hs, he, ws, we, ex = (t.long() for t in (hs, he, ws, we, ex))
    kept = _kept(hs, he, ws, we, ex) * valid.repeat(3)[:, None, None]
    p = valid.shape[0]
    box, frame, context = (int(kept[i * p:(i + 1) * p].sum()) for i in range(3))
    return {"box": box, "frame": frame, "context": context, "first_design": box + frame + context,
            "fused": box + context}


def staged_reads(hs, he, ws, we, ex, valid, h: int, w: int) -> Dict[str, int]:
    """Cells per channel the staged branch reads from shared memory
    ("shared") and from the map ("map"): the box rows' windows (read once
    for the box and frame rows) and the context rows' kept cells; each item
    belongs to the tile of its window's first cell (clamped into the map)
    and reads its window from the tile's region where the region holds it
    (as the kernel's Tile::holds), from the map otherwise."""
    hs, he, ws, we, ex = (t.long() for t in (hs, he, ws, we, ex))
    p = valid.shape[0]
    kept = _kept(hs, he, ws, we, ex) * valid.repeat(3)[:, None, None]
    s, r = kernel.STRIDE, kernel.REGION

    def held(rows):   # (P, PH, PW): whether the tile of each item's window holds it
        h0, h1 = hs[rows][:, :, None], he[rows][:, :, None]
        w0, w1 = ws[rows][:, None, :], we[rows][:, None, :]
        y0, x0 = h0.clamp(max=h - 1) // s * s, w0.clamp(max=w - 1) // s * s
        inside = (h0 >= y0) & (h1 <= torch.clamp(y0 + r, max=h)) & (w0 >= x0) & (
            w1 <= torch.clamp(x0 + r, max=w))
        return (h1 <= h0) | (w1 <= w0) | inside

    parts = [(kept[:p], held(slice(0, p))), (kept[2 * p:], held(slice(2 * p, 3 * p)))]
    return {"shared": sum(int((c * m).sum()) for c, m in parts),
            "map": sum(int((c * ~m).sum()) for c, m in parts)}


def tile_grid(h: int, w: int, c: int, dtype: torch.dtype) -> Dict[str, int]:
    """The staged branch's grid, as the source's launcher sizes it: tiles
    down and across, channel groups (32 lanes' vectors each), blocks a tile
    (enough for kMinBlocks in all), blocks, the dynamic shared memory a
    block, and the bytes the blocks stage from the map (each its region
    clipped to the map, its group's channels)."""
    vec = VEC_BYTES // dtype.itemsize
    s, r = kernel.STRIDE, kernel.REGION
    ty, tx = -(-h // s), -(-w // s)
    groups = -(-(c // vec) // 32)
    split = -(-kernel.MIN_BLOCKS // (ty * tx * groups))
    rows = sum(min(r, h - y * s) for y in range(ty))
    cols = sum(min(r, w - x * s) for x in range(tx))
    return {"tiles_y": ty, "tiles_x": tx, "groups": groups, "split": split,
            "blocks": ty * tx * groups * split, "smem_bytes": r * r * CELL_VECS * VEC_BYTES,
            "staged_bytes": rows * cols * c * dtype.itemsize * split}


def adversarial_inputs(device, c: int, seed: int = 0):
    """A 24 x 40 map of ``c`` channels with a zero block (regions there give
    0 and pos -1) and a negative block, and 64 boxes: the whole image, on its
    right and bottom edges, below one cell, of zero size, on the zero and the
    negative block, random ones; the last 4 invalid. Returns (feat f32,
    boxes, valid, rs)."""
    rng = np.random.RandomState(seed)
    h, w = 24, 40
    feat = rng.randn(h, w, c).astype(np.float32)
    feat[0:8, 0:12] = 0.0
    feat[12:20, 20:40] = -np.abs(feat[12:20, 20:40])
    img_h, img_w = 8 * h, 8 * w
    p = 64
    x1, y1 = rng.uniform(0, img_w - 10, p), rng.uniform(0, img_h - 10, p)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(2, img_w / 2, p), img_w),
                      np.minimum(y1 + rng.uniform(2, img_h / 2, p), img_h)], 1)
    boxes[:8] = [[0, 0, img_w, img_h], [img_w - 30, 10, img_w, 100],
                 [0, img_h - 20, 50, img_h], [3, 3, 4, 4], [50, 50, 50, 50],
                 [0, 0, 90, 60], [170, 100, 310, 150], [img_w - 8, img_h - 8, img_w, img_h]]
    valid = np.arange(p) < p - 4
    rs = rng.uniform(1, 2, p).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(feat), t(boxes.astype(np.float32)), t(valid), t(rs)


def _launch(lib, feat, win, ex, valid, rs, with_pos: bool):
    """One call of ``lib``'s kernel, allocating as the wrapper does:
    (out, pos or None, the branch the library reports)."""
    shape = (*win[0].shape, win[2].shape[1], feat.shape[2])
    out = torch.empty(shape, dtype=feat.dtype, device=feat.device)
    pos = torch.empty(shape, dtype=torch.int32, device=feat.device) if with_pos else None
    return out, pos, kernel.launch(lib, feat, *win, ex, valid, rs, out, pos)


def pool(lib, feat, win, ex, valid, rs, with_pos: bool):
    """One call of ``lib``'s kernel, without the wrapper's checks."""
    return _launch(lib, feat, win, ex, valid, rs, with_pos)[:2]


def branch_of(feat, win, ex, valid, rs) -> str:
    """The branch the current build takes for these inputs with pos."""
    return _launch(kernel._lib(), feat, win, ex, valid, rs, True)[2]


def _wrapper(feat, win, ex, valid, rs, with_pos: bool):
    return roi_loop_pool_fwd_cuda(feat, *win, ex, valid, rs, return_argmax=with_pos)


Pool = Callable[..., tuple]   # (feat, win, ex, valid, row_scale, with_pos) -> (out, pos or None)


def plain(feat, win, ex, valid, rs):
    """The plain version's out and pos with scale, and its out without."""
    return (*roi_loop_pool_reference(feat, *win, ex, valid, rs),
            roi_loop_pool_reference(feat, *win, ex, valid, None)[0])


def check(feat, win, ex, valid, rs, pools: Optional[Dict[str, Pool]] = None,
          want: Optional[tuple] = None) -> float:
    """Raise unless every pool (default: the wrapper) equals the plain
    version bit for bit: out and pos with scale, out without pos, and out
    without scale (``want``: ``plain`` of the same values, where it was
    computed already). Returns the largest absolute difference of out
    (0.0)."""
    out_p, pos_p, out_n = want if want is not None else plain(feat, win, ex, valid, rs)
    err = 0.0
    for label, fn in (pools or {"roi_loop_pool_fwd": _wrapper}).items():
        out_k, pos_k = fn(feat, win, ex, valid, rs, True)
        out_i, none = fn(feat, win, ex, valid, rs, False)
        out_s, _ = fn(feat, win, ex, valid, None, False)
        if none is not None:
            raise AssertionError(f"{label}: a call without pos returned one")
        for name, a, b in (("out", _bits(out_k), _bits(out_p)), ("pos", pos_k, pos_p),
                           ("out without pos", _bits(out_i), _bits(out_p)),
                           ("out without scale", _bits(out_s), _bits(out_n))):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {name} differs from the plain version in "
                                     f"{int((a != b).sum())} elements, feat "
                                     f"{tuple(feat.shape)} {feat.dtype}")
        err = max(err, float((out_k.float() - out_p.float()).abs().max()))
    return err


def check_bwd(g, pos, rs3, win, valid3, h: int, w: int) -> torch.Tensor:
    """Raise unless kernel A bwd over the 3P rows is bit-identical to the
    plain backward run on the CPU and to itself across two launches.
    Returns the kernel's gradient."""
    acc = roi_pool_bwd_cuda(g, pos, rs3, *win, valid3, h, w)
    again = roi_pool_bwd_cuda(g, pos, rs3, *win, valid3, h, w)
    on_cpu = roi_pool_backward_reference(g.cpu(), pos.cpu(), rs3.cpu(), h, w)
    if not torch.equal(_bits(acc), _bits(again)):
        raise AssertionError("roi_loop_pool backward: two launches differ")
    if not torch.equal(_bits(acc.cpu()), _bits(on_cpu)):
        n = int((acc.cpu() != on_cpu).sum())
        raise AssertionError(f"roi_loop_pool backward: differs from the plain backward on the "
                             f"CPU in {n} elements, g {tuple(g.shape)} {g.dtype}")
    return acc


def _backward_inputs(feat, win, valid, rs, seed: int):
    """A random cotangent of the 3P rows in the feature dtype, the kernel's
    argmax, the repeated scale and validity."""
    _, pos = roi_loop_pool_fwd_cuda(feat, *win, valid, rs)
    gen = torch.Generator(device=feat.device).manual_seed(seed)
    g = torch.randn(pos.shape, generator=gen, device=feat.device).to(feat.dtype)
    return g, pos, rs.to(feat.dtype).float().repeat(3), valid.repeat(3)


def misaligned(feat: torch.Tensor) -> torch.Tensor:
    """A copy of ``feat`` one element past a 16-byte boundary (the direct
    branch's input at any shape)."""
    buf = torch.empty(feat.numel() + 8, dtype=feat.dtype, device=feat.device)
    out = buf[1:1 + feat.numel()].view(feat.shape)
    out.copy_(feat)
    return out


def case_inputs(device, hwc, seed: int = 0):
    """The main path's inputs at an (h, w, c) map (``production_pool_inputs``)
    and their 3P rows' windows: (feat f32, win, ex, valid, rs)."""
    feat32, boxes, valid, rs = production_pool_inputs(device, hwc, seed)
    h, w, _ = hwc
    *win, ex = loop_windows(boxes, valid, h, w, 7, 7, SCALE)
    return feat32, tuple(win), ex, valid, rs


def case_name(hwc, dtype) -> str:
    return f"{hwc[0]}x{hwc[1]}x{hwc[2]} {str(dtype)[6:]}"


def l2_bytes(branch: str, feat, win, ex, valid) -> int:
    """Bytes the current build reads from L2 for the map: the staged branch
    its blocks' regions and the windows it reads from the map, the direct
    branch every cell it scans, at the map's channels."""
    h, w, c = feat.shape
    isz = feat.element_size()
    if branch == "staged":
        reads = staged_reads(*win, ex, valid, h, w)
        return tile_grid(h, w, c, feat.dtype)["staged_bytes"] + reads["map"] * c * isz
    return scan_cells(*win, ex, valid)["fused"] * c * isz


def run(device, iters: int = 20, seed: int = 0) -> Dict[str, dict]:
    """Every check and time of the current build; returns the results by
    case (``case_name``; the production shape's also under "bfloat16" and
    "float32"; the misaligned and the adversarial ones), each with branch,
    max_abs_err, ms (with pos, as called through the wrapper), device_ms
    (the kernel alone), ms_nopos, device_ms_nopos, bound_ms, bound_nopos_ms,
    cells and l2_gb; the production shape's with plain_ms (bf16) and
    bwd_ms."""
    res = {}
    lib = kernel._lib()
    for hwc, dtype in RUN_CASES:
        feat32, win, ex, valid, rs = case_inputs(device, hwc, seed)
        h, w, c = hwc
        p = valid.shape[0]
        feat = feat32.to(dtype)
        want = plain(feat, win, ex, valid, rs)
        err = check(feat, win, ex, valid, rs, want=want)
        call = lambda: roi_loop_pool_fwd_cuda(feat, *win, ex, valid, rs)  # noqa: E731
        call_nopos = lambda: roi_loop_pool_fwd_cuda(  # noqa: E731
            feat, *win, ex, valid, rs, return_argmax=False)
        isz = feat.element_size()
        branch = branch_of(feat, win, ex, valid, rs)
        cells = scan_cells(*win, ex, valid)
        if branch == "staged":
            cells.update(staged_reads(*win, ex, valid, h, w))
        r = {"branch": branch, "max_abs_err": err,
             "ms": cuda_ms(call, iters),
             "device_ms": device_ms(lambda: pool(lib, feat, win, ex, valid, rs, True), iters),
             "ms_nopos": cuda_ms(call_nopos, iters),
             "device_ms_nopos": device_ms(lambda: pool(lib, feat, win, ex, valid, rs, False),
                                          iters),
             "bound_ms": bound_ms(traffic_bytes(h, w, c, p, 7, 7, isz, True)),
             "bound_nopos_ms": bound_ms(traffic_bytes(h, w, c, p, 7, 7, isz, False)),
             "cells": cells, "l2_gb": l2_bytes(branch, feat, win, ex, valid) / 1e9}
        if hwc == FEAT_HWC:   # the backward at the production shape, the plain time in bf16
            if dtype == torch.bfloat16:
                r["plain_ms"] = cuda_ms(
                    lambda: roi_loop_pool_reference(feat, *win, ex, valid, rs), 1)
                misaligned_case = (feat, win, ex, valid, rs, want)
            g, pos, rs3, valid3 = _backward_inputs(feat, (*win, ex), valid, rs, seed)
            check_bwd(g, pos, rs3, win, valid3, h, w)
            r["bwd_ms"] = cuda_ms(lambda: roi_pool_bwd_cuda(g, pos, rs3, *win, valid3, h, w),
                                  iters)
            res[str(dtype)[6:]] = r
            del g, pos
        res[case_name(hwc, dtype)] = r
        del want
    feat, win, ex, valid, rs, want = misaligned_case
    feat = misaligned(feat)
    call = lambda: roi_loop_pool_fwd_cuda(feat, *win, ex, valid, rs)  # noqa: E731
    call_nopos = lambda: roi_loop_pool_fwd_cuda(  # noqa: E731
        feat, *win, ex, valid, rs, return_argmax=False)
    res[case_name(FEAT_HWC, torch.bfloat16) + " misaligned"] = {
        "branch": branch_of(feat, win, ex, valid, rs),
        "max_abs_err": check(feat, win, ex, valid, rs, want=want),
        "ms": cuda_ms(call, iters), "ms_nopos": cuda_ms(call_nopos, iters)}
    del want, misaligned_case
    for ch in (136, 3):
        feat32, boxes, valid, rs = adversarial_inputs(device, ch, seed)
        ah, aw, _ = feat32.shape
        *win, ex = loop_windows(boxes, valid, ah, aw, 7, 7, SCALE)
        for dtype in (torch.bfloat16, torch.float32):
            feat = feat32.to(dtype)
            err = check(feat, tuple(win), ex, valid, rs)
            g, pos, rs3, valid3 = _backward_inputs(feat, (*win, ex), valid, rs, seed)
            check_bwd(g, pos, rs3, win, valid3, ah, aw)
            res[f"adversarial C={ch} {str(dtype)[6:]}"] = {
                "max_abs_err": err, "empty_bins": int((pos[..., 0] < 0).sum()),
                "branch": branch_of(feat, tuple(win), ex, valid, rs)}
    return res


def report(res: Dict[str, dict], log=print) -> None:
    for name, r in res.items():
        if name in ("bfloat16", "float32"):
            continue
        if name.endswith("misaligned"):
            log(f"roi_loop_pool_fwd {name} ({r['branch']} branch): out and pos equal to the "
                f"plain version (with pos and scale, without pos, without scale); with pos "
                f"{r['ms']:.3f} ms as called, without pos {r['ms_nopos']:.3f} ms")
            continue
        if name.startswith("adversarial"):
            log(f"roi_loop_pool_fwd {name} ({r['branch']} branch): out and pos equal to the "
                f"plain version (with pos and scale, without pos, without scale; "
                f"{r['empty_bins']} bins of channel 0 at 0 with pos -1); backward bit-identical "
                f"to the plain backward on the CPU and across two launches")
            continue
        bwd = (f"; backward (A bwd over 3P rows) bit-identical to the plain backward on the "
               f"CPU and across two launches, {r['bwd_ms']:.3f} ms" if "bwd_ms" in r else "")
        if "plain_ms" in r:
            bwd = f"; plain {r['plain_ms']:.3f} ms" + bwd
        cells = r["cells"]
        shared = (f" ({cells['shared']:,} from shared memory)" if "shared" in cells else "")
        log(f"roi_loop_pool_fwd {name} P=4096 -> 3P rows ({r['branch']} branch): out and pos "
            f"equal to the plain version (with pos and scale, without pos, without scale); with "
            f"pos {r['ms']:.3f} ms as called, {r['device_ms']:.3f} ms the kernel on the device "
            f"(bound {r['bound_ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% of the call); "
            f"without pos {r['ms_nopos']:.3f} / {r['device_ms_nopos']:.3f} ms "
            f"(bound {r['bound_nopos_ms']:.4f} ms); cells "
            f"{cells['fused']:,} read{shared} (first design {cells['first_design']:,}), "
            f"{r['l2_gb']:.3f} GB of the map from L2{bwd}")


def direct_source() -> pathlib.Path:
    """A copy of the current source with kTiledMaxW = 0 (every shape on the
    direct branch), written under build/ for a baseline build."""
    src = (kbuild.CSRC_DIR / "roi_loop_pool_fwd.cu").read_text()
    src, n = re.subn(r"constexpr int kTiledMaxW = \d+;", "constexpr int kTiledMaxW = 0;", src)
    if n != 1:
        raise RuntimeError("no single constant kTiledMaxW in roi_loop_pool_fwd.cu")
    out = kbuild.BUILD_DIR / "sweep" / "roi_loop_pool_fwd_direct.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def builds(args) -> Dict[str, object]:
    """label -> library: the baselines, the direct variant and the current
    source, one nvcc each, all at once."""
    specs = [spec.split("=", 1) for spec in args.baseline]
    if args.direct:
        specs.append(("direct", str(direct_source())))
    specs.append(("current", None))
    with ThreadPoolExecutor(len(specs)) as ex:
        paths = list(ex.map(lambda s: kbuild.build(
            "roi_loop_pool_fwd_" + re.sub(r"\W", "_", s[0]) if s[1] else "roi_loop_pool_fwd",
            s[1]), specs))
    return {label: kernel.bind(path) for (label, _), path in zip(specs, paths)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH: another source with the kernel's C interface")
    ap.add_argument("--direct", action="store_true",
                    help="also time the current source with every shape on the direct branch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_roi_loop_pool needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    libs = builds(args)
    print(f"{torch.cuda.get_device_name(0)} | {card}", flush=True)
    print(compiler_report(kbuild.library_path("roi_loop_pool_fwd")), flush=True)
    pools = {label: functools.partial(pool, lib) for label, lib in libs.items()}
    for hwc, dtype in CASES:
        feat32, win, ex, valid, rs = case_inputs(device, hwc, args.seed)
        h, w, c = hwc
        feat = feat32.to(dtype)
        check(feat, win, ex, valid, rs, pools)
        cells = scan_cells(*win, ex, valid)
        isz = feat.element_size()
        branch = branch_of(feat, win, ex, valid, rs)
        if branch == "staged":
            cells.update(staged_reads(*win, ex, valid, h, w))
        gb = l2_bytes(branch, feat, win, ex, valid) / 1e9
        for with_pos in (True, False):
            times = in_turns({label: functools.partial(fn, feat, win, ex, valid, rs, with_pos)
                              for label, fn in pools.items()}, args.iters)
            nbytes = traffic_bytes(h, w, c, valid.shape[0], 7, 7, isz, with_pos)
            bound = bound_ms(nbytes)
            cur = statistics.median(times["current"])
            shared = (f", {cells['shared']:,} of them from shared memory"
                      if branch == "staged" else "")
            print(f"{case_name(hwc, dtype)} {'pos' if with_pos else 'no pos':6s} | "
                  f"{fmt_turns(times)} | bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), current at "
                  f"{100 * bound / cur:.1f}% of it | {branch} branch | cells read "
                  f"{cells['fused']:,}{shared} (first design {cells['first_design']:,}: box "
                  f"{cells['box']:,}, frame {cells['frame']:,}, context {cells['context']:,}) | "
                  f"the map from L2 {gb:.3f} GB (first design "
                  f"{cells['first_design'] * c * isz / 1e9:.3f}) | {card}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
