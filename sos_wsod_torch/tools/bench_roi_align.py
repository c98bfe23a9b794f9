"""The multi-level ROIAlign kernels (csrc/roi_align_fwd.cu, csrc/roi_align_bwd.cu)
against their plain versions at the FPN box head's shapes, on one GPU.

    python -m sos_wsod_torch.tools.bench_roi_align [--iters 20] [--seed 0]
        [--baseline LABEL=OLD_ROI_ALIGN_FWD.cu ...] [--kernel fwd|bwd]

The inputs (``fpn_inputs``): p2-p5 of a 704 x 960 canvas, 256 channels
(176x240, 88x120, 44x60, 22x30), and 1000 proposals inside the 688 x 917
image with sides drawn log-uniform from 8 to 900 px (cut to the image), so
every level gets boxes; 5% of the slots invalid. In bfloat16 and float32 it checks that the
kernel's output equals the plain version's (torch.equal) and prints the
median CUDA-event time as called (``measure.cuda_ms``) and in device time
(``measure.device_ms``, the host's launch hidden behind a spin kernel),
beside the bound and the plain version's time. The bound is the larger of
two: the bytes the function must move (maps read once, output written once)
over 3.35 TB/s, and its f32 operations, ``kernels/roi_align.py:
OPS_PER_SAMPLE`` for each channel of each sample of each valid ROI's actual
grid, over 67 TFLOP/s.

A baseline is another source with the same C interface, built and timed in
turns with the current one (baselines, current, then the same in reverse),
as called and in device time: an earlier version kept for the comparison
(``git show <commit>:sos_wsod_torch/csrc/roi_align_fwd.cu >
build/parent/roi_align_fwd.cu``) or a copy with other constants. Each is
held equal to the plain version too.

``--kernel bwd`` checks and times the backward instead (``run_bwd``): at
the training step's shapes, 512 sampled ROIs on p2-p5 of the 704 x 960
canvas and of the largest training canvas, 1216 x 1664, in bfloat16 and
float32, and on the adversarial cases, each within ``BWD_RTOL``/``BWD_ATOL``
of the plain backward run on the card (atomics sum in a run-dependent
order). It prints the kernel's time as called and on the device beside the
bound (g read once and every level's gradient written once, or
``kernels/roi_align_bwd.py:OPS_PER_SAMPLE`` f32 operations for each channel
of each sample), the plain backward's time, and ``index_add_``'s time for
the same contributions alone (precomputed rows and terms), the library
call that a scatter-add would be.
"""
from __future__ import annotations

import argparse
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import roi_align as kernel
from ..kernels import roi_align_bwd as bwd_kernel
from ..models.roi_heads.standard import assign_boxes_to_levels
from ..ops.roi_align import (
    _sample_geometry, roi_align_levels_backward_reference, roi_align_levels_reference)
from .measure import bound_ms, card_line, cuda_ms, device_ms, fmt_turns, in_turns, ops_bound_ms

CANVAS = (704, 960)
IMAGE_HW = (688, 917)
STRIDES = (4, 8, 16, 32)
NUM_ROIS = 1000
CHANNELS = 256
TRAIN_ROIS = 512                       # ROI_HEADS.BATCH_SIZE_PER_IMAGE
TOP_CANVAS = (1216, 1664)              # short side 1216 of a 375 x 500 image, padded
TOP_IMAGE_HW = (1216, 1621)
# the backward against the plain backward: |kernel - plain| <= BWD_RTOL x
# max|plain| + BWD_ATOL on the f32 sums (both sum with atomics on the card,
# in run-dependent orders); in bf16 one bf16 ulp more, for sums that round
# to neighbouring bf16 values
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6


def fpn_inputs(device, dtype, seed: int, p: int = NUM_ROIS, c: int = CHANNELS,
               canvas: Tuple[int, int] = CANVAS, image_hw: Tuple[int, int] = IMAGE_HW):
    """(features per level (H_l, W_l, C), boxes (P, 4) f32, valid (P,),
    level (P,) int32, spatial scales)."""
    rng = np.random.default_rng(seed)
    feats: List[torch.Tensor] = []
    for s in STRIDES:
        hw = (-(-canvas[0] // s), -(-canvas[1] // s))
        feats.append(torch.from_numpy(rng.standard_normal((*hw, c), dtype=np.float32))
                     .to(device=device, dtype=dtype))
    ih, iw = image_hw
    side = np.minimum(np.exp(rng.uniform(np.log(8), np.log(900), (p, 2))), [iw, ih])
    x1 = rng.uniform(0, iw - side[:, 0])
    y1 = rng.uniform(0, ih - side[:, 1])
    boxes = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], 1).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(device)
    valid = torch.from_numpy(rng.uniform(0, 1, p) > 0.05).to(device)
    level = assign_boxes_to_levels(boxes, 2, 5)
    return feats, boxes, valid, level, [1.0 / s for s in STRIDES]


def adversarial_cases(device, dtype, seed: int = 0) -> Dict[str, tuple]:
    """name -> (inputs, keywords) of the cases beyond the FPN head's: a
    sample cap of 16, fixed sampling ratios (20 overflows the sample tables),
    ROIAlign V1, 3 and 12 channels (one channel a thread in bf16, and 3 in
    f32 too), whole-map, out-of-map and reversed ROIs on p2 alone (176 x 240
    x 256, windows far above the shared memory), and long thin ROIs on a
    1344-wide canvas (up to 336 x 5 cells on p2, some beyond the buffer)."""
    base = fpn_inputs(device, dtype, seed, p=200)
    feats, _, _, _, scales = base
    rng = np.random.default_rng(seed + 1)
    b = [[0, 0, 960, 704], [-40, -40, 1000, 750], [0, 0, 960, 8], [0, 0, 8, 704],
         [100, 100, 90, 95], [-300, -300, -200, -250], [950, 690, 1200, 900]]
    x1, y1 = rng.uniform(-20, 900, 57), rng.uniform(-20, 680, 57)
    b += np.stack([x1, y1, x1 + rng.uniform(1, 900, 57), y1 + rng.uniform(1, 700, 57)], 1).tolist()
    boxes = torch.tensor(b, dtype=torch.float32, device=device)
    p2 = ([feats[0]], boxes, torch.ones(len(b), dtype=torch.bool, device=device),
          torch.zeros(len(b), dtype=torch.int32, device=device), [scales[0]])
    wide = fpn_inputs(device, dtype, seed, p=200, canvas=(704, 1344), image_hw=(688, 1333))
    wf, _, wv, _, ws = wide
    tx, ty = rng.uniform(0, 40, 200), rng.uniform(0, 676, 200)
    thin = np.stack([tx, ty, np.minimum(tx + rng.uniform(1000, 1333, 200), 1333),
                     ty + rng.uniform(2, 12, 200)], 1)
    tb = torch.from_numpy(thin.astype(np.float32)).to(device)
    return {
        "sample_cap 16": (base, {"sample_cap": 16}),
        "sampling_ratio 2": (base, {"sampling_ratio": 2}),
        "sampling_ratio 3": (base, {"sampling_ratio": 3}),
        "sampling_ratio 20": (fpn_inputs(device, dtype, seed, p=40), {"sampling_ratio": 20}),
        "aligned False": (base, {"aligned": False}),
        "C 3": (fpn_inputs(device, dtype, seed, p=200, c=3), {}),
        "C 12": (fpn_inputs(device, dtype, seed, p=200, c=12), {}),
        "whole map p2": (p2, {}),
        "whole map p2, sample_cap 16": (p2, {"sample_cap": 16}),
        "long ROIs, 1344 wide": ((wf, tb, wv, assign_boxes_to_levels(tb, 2, 5), ws), {}),
    }


def check(feats, boxes, valid, level, scales, fn: Optional[Callable] = None, **kw) -> float:
    """Kernel (the wrapper's, else ``fn`` with its signature) against the
    plain version on the same inputs; raises unless torch.equal. Returns the
    max abs difference (0)."""
    got = (fn or kernel.roi_align_fwd_cuda)(feats, boxes, valid, level, scales, **kw)
    got = got.permute(0, 3, 1, 2)
    want = roi_align_levels_reference(feats, boxes, valid, level, scales, **kw)
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"ROIAlign kernel differs from the plain version in {n} of "
                             f"{got.numel()} elements")
    return float((got.float() - want.float()).abs().max())


def bounds(feats, boxes, valid, level, scales, **kw) -> dict:
    """The least time of the function on these inputs, by bytes and by
    operations, and which of the two binds; with the operation count and
    the ROIs of each branch (``kernels/roi_align.py:roi_geometry``)."""
    g = kernel.roi_geometry([f.shape[:2] for f in feats], boxes, valid, level, scales, **kw)
    out_hw = kw.get("output_size", (7, 7))
    ops = kernel.operations(g["grid_h"], g["grid_w"], valid, feats[0].shape[-1], out_hw)
    bytes_ms = bound_ms(kernel.traffic_bytes(feats, boxes.shape[0], out_hw))
    ops_ms = ops_bound_ms(ops)
    staged = int(g["staged"].sum())
    return {"ops": ops, "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "staged": staged, "direct": int(valid.sum()) - staged,
            "two_buffers": int(g["two_buffers"].sum())}


def launcher(lib, feats, boxes, valid, level, scales, *, output_size=(7, 7),
             sampling_ratio=0, aligned=True, sample_cap=8):
    """A build's kernel with the wrapper's signature, outside its count."""
    c = feats[0].shape[-1]
    out = torch.empty((boxes.shape[0], *output_size, c), dtype=feats[0].dtype,
                      device=feats[0].device)
    kernel.launch(lib, feats, boxes, valid, level, scales, out, sampling_ratio=sampling_ratio,
                  cap=sampling_ratio if sampling_ratio > 0 else sample_cap, aligned=aligned)
    return out


def builds(baselines: Sequence[str] = ()) -> Dict[str, Callable]:
    """label -> launcher with the wrapper's signature: each LABEL=PATH
    baseline, then the current source. They launch the libraries directly,
    so they leave the wrapper's launch count alone."""
    specs = [spec.split("=", 1) for spec in baselines] + [("current", None)]
    with ThreadPoolExecutor(len(specs)) as ex:   # one nvcc each, all at once
        paths = list(ex.map(
            lambda sp: kbuild.build(f"roi_align_fwd_{sp[0]}" if sp[1] else "roi_align_fwd",
                                    sp[1]), specs))
    return {label: functools.partial(launcher, kernel.bind(path))
            for (label, _), path in zip(specs, paths)}


def run(device, iters: int = 20, seed: int = 0,
        baselines: Sequence[str] = ()) -> Dict[str, dict]:
    """Check and time both dtypes; returns {dtype: {ms, device_ms, plain_ms,
    bound_ms, bound_by, turns, ...}}. ``ms`` is the wrapper as a caller
    waits for it, ``device_ms`` the current build's device time alone (the
    median of its turns); ``turns`` holds every build's times in turns,
    "call" (``cuda_ms``) and "device" (``device_ms``)."""
    libs = builds(baselines)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = fpn_inputs(device, dtype, seed)
        feats, boxes, valid, level, scales = args
        err = check(*args)
        for fn in libs.values():
            check(*args, fn=fn)
        ms = cuda_ms(lambda: kernel.roi_align_fwd_cuda(*args), iters)
        fns = {label: functools.partial(fn, *args) for label, fn in libs.items()}
        turns = {"call": in_turns(fns, iters, cuda_ms), "device": in_turns(fns, iters, device_ms)}
        plain_ms = cuda_ms(lambda: roi_align_levels_reference(*args), 3)
        per_level = torch.bincount(level[valid].long(), minlength=len(STRIDES)).tolist()
        out[str(dtype)[6:]] = {"max_abs_err": err, "ms": ms,
                               "device_ms": float(np.median(turns["device"]["current"])),
                               "plain_ms": plain_ms, "turns": turns,
                               "rois_per_level": per_level, **bounds(*args)}
    return out


def bwd_inputs(device, dtype, seed: int, canvas: Tuple[int, int] = CANVAS,
               image_hw: Tuple[int, int] = IMAGE_HW, p: int = TRAIN_ROIS, c: int = CHANNELS):
    """(grad (P, PH, PW, C) in ``dtype``, level shapes, boxes, valid, level,
    scales) of ``fpn_inputs``: the upstream gradient is unit normal."""
    feats, boxes, valid, level, scales = fpn_inputs(device, dtype, seed, p=p, c=c,
                                                    canvas=canvas, image_hw=image_hw)
    gen = torch.Generator(device=device).manual_seed(seed)
    grad = torch.randn((p, 7, 7, c), generator=gen, device=device).to(dtype)
    return grad, [tuple(f.shape[:2]) for f in feats], boxes, valid, level, scales


def bwd_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``t`` (0 at 0)."""
    e = torch.frexp(t.float()).exponent
    return torch.where(t == 0, torch.zeros_like(t, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8))


def check_bwd(grad, shapes, boxes, valid, level, scales, **kw) -> Tuple[float, float]:
    """The backward kernel against the plain backward on the same inputs:
    raises unless every level's gradient is within BWD_RTOL x max|plain| +
    BWD_ATOL of the plain one's f32 sums (bf16: of them rounded to bf16, one
    bf16 ulp more). Returns (max |difference|, the tolerance)."""
    got = bwd_kernel.roi_align_bwd_cuda(grad, shapes, boxes, valid, level, scales, **kw)
    want = roi_align_levels_backward_reference(grad.permute(0, 3, 1, 2), shapes, boxes, valid,
                                               level, scales, dtype=torch.float32, **kw)
    tol = BWD_RTOL * max(float(w.abs().max()) for w in want) + BWD_ATOL
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != grad.dtype or tuple(g.shape) != (*shapes[i], grad.shape[-1]):
            raise AssertionError(f"level {i}: gradient {g.dtype} {tuple(g.shape)}")
        w = w.to(g.dtype)
        diff = (g.float() - w.float()).abs()
        limit = tol + (bwd_ulp(torch.maximum(g.float().abs(), w.float().abs()))
                       if g.dtype == torch.bfloat16 else 0.0)
        bad = ~(diff <= limit)
        if bad.any():
            raise AssertionError(f"ROIAlign backward level {i}: {int(bad.sum())} of {g.numel()} "
                                 f"elements beyond the tolerance (max |d| "
                                 f"{float(diff.max()):.3e}, tolerance {tol:.3e})")
        err = max(err, float(diff.max()))
    return err, tol


def bwd_bounds(grad, shapes, boxes, valid, level, scales, **kw) -> dict:
    """The backward's least time on these inputs, by bytes and by
    operations, and which binds; with the sample count."""
    g = kernel.roi_geometry(shapes, boxes, valid, level, scales, **kw)
    p, ph, pw, c = grad.shape
    samples = int((g["grid_h"].long() * g["grid_w"].long() * valid).sum()) * ph * pw
    bytes_ms = bound_ms(bwd_kernel.traffic_bytes(shapes, c, p, grad.element_size(), (ph, pw)))
    ops_ms = ops_bound_ms(samples * c * bwd_kernel.OPS_PER_SAMPLE)
    return {"samples": samples, "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def index_add_bwd_ms(grad, shapes, boxes, valid, level, scales, iters: int, **kw) -> float:
    """The library call: one ``index_add_`` of the backward's contributions
    (the rows and terms of the valid ROIs' samples, made beforehand) into a
    zeroed f32 map of every level."""
    c = grad.shape[-1]
    count, samples = _sample_geometry(shapes, boxes, valid, level, scales,
                                      kw.get("output_size", (7, 7)),
                                      kw.get("sampling_ratio", 0), kw.get("aligned", True),
                                      kw.get("sample_cap", 8))
    gc = grad.float() / count[:, None, None, None]
    rows, terms = [], []
    for idxs, wts, ok in samples:
        keep = (valid & (ok > 0))[:, None, None].expand(wts[0].shape)
        for ii, wt in zip(idxs, wts):
            rows.append(ii[keep])
            terms.append(gc[keep] * wt[keep][:, None])
    rows, terms = torch.cat(rows), torch.cat(terms)
    cells = sum(h * w for h, w in shapes)
    return cuda_ms(lambda: torch.zeros((cells, c), device=grad.device).index_add_(0, rows, terms),
                   iters)


def bwd_adversarial_cases(device, dtype, seed: int = 0) -> Dict[str, tuple]:
    """The forward's adversarial cases as backward inputs: name ->
    ((grad, shapes, boxes, valid, level, scales), keywords)."""
    out = {}
    for name, ((feats, boxes, valid, level, scales), kw) in adversarial_cases(
            device, dtype, seed).items():
        gen = torch.Generator(device=device).manual_seed(seed)
        grad = torch.randn((boxes.shape[0], 7, 7, feats[0].shape[-1]), generator=gen,
                           device=device).to(dtype)
        out[name] = ((grad, [tuple(f.shape[:2]) for f in feats], boxes, valid, level, scales),
                     kw)
    return out


def run_bwd(device, iters: int = 20, seed: int = 0) -> Dict[str, dict]:
    """Check and time the backward at both canvases and dtypes; returns
    {"<canvas> <dtype>": {ms, device_ms, plain_ms, library_ms, max_abs_err,
    tolerance, bound_ms, bound_by, ...}}."""
    out = {}
    for canvas, image_hw in ((CANVAS, IMAGE_HW), (TOP_CANVAS, TOP_IMAGE_HW)):
        for dtype in (torch.bfloat16, torch.float32):
            args = bwd_inputs(device, dtype, seed, canvas, image_hw)
            err, tol = check_bwd(*args)
            ms = cuda_ms(lambda: bwd_kernel.roi_align_bwd_cuda(*args), iters)
            dev_ms = device_ms(lambda: bwd_kernel.roi_align_bwd_cuda(*args), iters)
            grad = args[0]
            plain_ms = cuda_ms(lambda: roi_align_levels_backward_reference(
                grad.permute(0, 3, 1, 2), *args[1:]), 3)
            lib_ms = index_add_bwd_ms(*args, iters=iters)
            per_level = torch.bincount(args[4][args[3]].long(), minlength=len(STRIDES)).tolist()
            out[f"{canvas[0]}x{canvas[1]} {str(dtype)[6:]}"] = {
                "max_abs_err": err, "tolerance": tol, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "rois_per_level": per_level,
                **bwd_bounds(*args)}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH: another source of the kernel, timed in turns")
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    if args.kernel == "bwd":
        res = run_bwd(torch.device("cuda", 0), args.iters, args.seed)
        for name, r in res.items():
            print(f"[roi_align_bwd] {name} x {CHANNELS}, P={TRAIN_ROIS} (per level "
                  f"{r['rois_per_level']}, {r['samples']} samples): max |d| "
                  f"{r['max_abs_err']:.3e} within {r['tolerance']:.3e} of the plain backward; "
                  f"kernel {r['ms']:.4f} ms as called, {r['device_ms']:.4f} ms device; bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']} (bytes {r['bytes_bound_ms']:.4f}, "
                  f"operations {r['ops_bound_ms']:.4f}); plain {r['plain_ms']:.3f} ms; "
                  f"index_add_ {r['library_ms']:.3f} ms | {card}", flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            for name, (a, kw) in bwd_adversarial_cases(torch.device("cuda", 0), dtype,
                                                       args.seed).items():
                err, tol = check_bwd(*a, **kw)
                print(f"[roi_align_bwd] {str(dtype)[6:]} {name}: max |d| {err:.3e} within "
                      f"{tol:.3e}", flush=True)
        return res
    res = run(torch.device("cuda", 0), args.iters, args.seed, args.baseline)
    for dtype, r in res.items():
        print(f"[roi_align] {dtype} p2-p5 of {CANVAS} x {CHANNELS}, P={NUM_ROIS} (per level "
              f"{r['rois_per_level']}; staged {r['staged']} ({r['two_buffers']} with two "
              f"buffers), direct {r['direct']}): equal to "
              f"the plain version; kernel {r['ms']:.4f} ms as called, {r['device_ms']:.4f} ms "
              f"device; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['device_ms']:.1f}% of the device time; bytes "
              f"{r['bytes_bound_ms']:.4f}, operations {r['ops_bound_ms']:.4f} for {r['ops']}); "
              f"plain {r['plain_ms']:.3f} ms | {card}", flush=True)
        for kind, times in r["turns"].items():
            print(f"[roi_align] {dtype} in turns, {kind}: {fmt_turns(times)}", flush=True)
    return res


if __name__ == "__main__":
    main()
