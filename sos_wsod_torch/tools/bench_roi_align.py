"""The multi-level ROIAlign kernels (csrc/roi_align_fwd.cu, csrc/roi_align_bwd.cu)
against their plain versions at the FPN box head's shapes, on one GPU.

    python -m sos_wsod_torch.tools.bench_roi_align [--iters 20] [--seed 0]
        [--kernel fwd|bwd] [--baseline LABEL=OLD_SOURCE.cu ...] [--sweep]

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
float32, and on the adversarial cases, each bit-identical to the plain
backward run on the CPU and across two launches (``check_bwd``). It prints
the kernel's time as called and on the device beside the bound (g read once
and every level's gradient written once, or
``kernels/roi_align_bwd.py:OPS_PER_SAMPLE`` f32 operations for each channel
of each sample), the bin-tile pairs (each reads a bin's g row once), the
plain backward's time on the card, and ``index_add_``'s time for the same
terms alone (precomputed rows and values), the library call that a
scatter-add would be. Its baselines are backward sources, timed in turns
the same way: one with the earlier C interface of the f32 atomics (a zeroed
f32 accumulator beside the output, e.g. ``git show
5f1e554:sos_wsod_torch/csrc/roi_align_bwd.cu``) runs through an adapter
here and is held within ``ATOMIC_RTOL``/``ATOMIC_ATOL`` of the plain
backward; ``--sweep`` adds builds of the current source with other tile and
warp constants (``BWD_SWEEP``), each held bit-identical.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import roi_align as kernel
from ..kernels import roi_align_bwd as bwd_kernel
from ..models.roi_heads.standard import assign_boxes_to_levels
from ..ops.roi_align import (
    backward_terms, roi_align_levels_backward_reference, roi_align_levels_reference)
from .measure import bound_ms, card_line, cuda_ms, device_ms, fmt_turns, in_turns, ops_bound_ms

CANVAS = (704, 960)
IMAGE_HW = (688, 917)
STRIDES = (4, 8, 16, 32)
NUM_ROIS = 1000
CHANNELS = 256
TRAIN_ROIS = 512                       # ROI_HEADS.BATCH_SIZE_PER_IMAGE
TOP_CANVAS = (1216, 1664)              # short side 1216 of a 375 x 500 image, padded
TOP_IMAGE_HW = (1216, 1621)
# an earlier backward that sums with f32 atomics (a --baseline) against the
# plain backward: |kernel - plain| <= ATOMIC_RTOL x max|plain| + ATOMIC_ATOL
# on the f32 sums (the atomics add in a run-dependent order); in bf16 one
# bf16 ulp more, for sums that round to neighbouring bf16 values
ATOMIC_RTOL, ATOMIC_ATOL = 1e-5, 1e-6


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
               image_hw: Tuple[int, int] = IMAGE_HW, p: int = TRAIN_ROIS, c: int = CHANNELS,
               output_size: Tuple[int, int] = (7, 7)):
    """(grad (P, PH, PW, C) in ``dtype``, level shapes, boxes, valid, level,
    scales) of ``fpn_inputs``: the upstream gradient is unit normal, PH x PW
    ``output_size`` (the box head's 7 x 7, the mask head's 14 x 14)."""
    feats, boxes, valid, level, scales = fpn_inputs(device, dtype, seed, p=p, c=c,
                                                    canvas=canvas, image_hw=image_hw)
    gen = torch.Generator(device=device).manual_seed(seed)
    grad = torch.randn((p, *output_size, c), generator=gen, device=device).to(dtype)
    return grad, [tuple(f.shape[:2]) for f in feats], boxes, valid, level, scales


def bwd_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``t`` (0 at 0)."""
    e = torch.frexp(t.float()).exponent
    return torch.where(t == 0, torch.zeros_like(t, dtype=torch.float32),
                       torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8))


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_bwd(grad, shapes, boxes, valid, level, scales, fn: Optional[Callable] = None,
              **kw) -> float:
    """The backward kernel (the wrapper's, else ``fn`` with its signature)
    against the plain backward run on the CPU on the same inputs: raises
    unless every level's gradient is of grad's dtype and shape, equal to
    the plain one bit for bit, and equal bit for bit across two launches.
    Returns the largest absolute difference (0.0)."""
    fn = fn or bwd_kernel.roi_align_bwd_cuda
    got = fn(grad, shapes, boxes, valid, level, scales, **kw)
    again = fn(grad, shapes, boxes, valid, level, scales, **kw)
    want = roi_align_levels_backward_reference(
        grad.cpu().permute(0, 3, 1, 2), shapes, boxes.cpu(), valid.cpu(), level.cpu(), scales,
        output_size=tuple(grad.shape[1:3]), **kw)
    err = 0.0
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        if g.dtype != grad.dtype or tuple(g.shape) != (*shapes[i], grad.shape[-1]):
            raise AssertionError(f"level {i}: gradient {g.dtype} {tuple(g.shape)}")
        if not torch.equal(bits(g), bits(a)):
            raise AssertionError(f"ROIAlign backward level {i}: two launches differ in "
                                 f"{int((g != a).sum())} of {g.numel()} elements")
        g = g.cpu()
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"ROIAlign backward level {i}: differs from the plain backward "
                                 f"in {int((bits(g) != bits(w)).sum())} of {g.numel()} "
                                 f"elements (max |d| {float((g.float() - w.float()).abs().max()):.3e})")
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def check_bwd_close(grad, shapes, boxes, valid, level, scales, fn: Callable, **kw) -> float:
    """An earlier build that sums with f32 atomics (``--baseline`` with the
    earlier C interface) against the plain backward: within ATOMIC_RTOL x
    max|plain| + ATOMIC_ATOL of the f32 sums, in bf16 one bf16 ulp more.
    Returns the largest absolute difference."""
    got = fn(grad, shapes, boxes, valid, level, scales, **kw)
    want = roi_align_levels_backward_reference(grad.permute(0, 3, 1, 2), shapes, boxes, valid,
                                               level, scales, output_size=tuple(grad.shape[1:3]),
                                               dtype=torch.float32, **kw)
    tol = ATOMIC_RTOL * max(float(w.abs().max()) for w in want) + ATOMIC_ATOL
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.to(g.dtype)
        diff = (g.float() - w.float()).abs()
        limit = tol + (bwd_ulp(torch.maximum(g.float().abs(), w.float().abs()))
                       if g.dtype == torch.bfloat16 else 0.0)
        bad = ~(diff <= limit)
        if bad.any():
            raise AssertionError(f"ROIAlign backward level {i}: {int(bad.sum())} of {g.numel()} "
                                 f"elements beyond the atomics' tolerance {tol:.3e}")
        err = max(err, float(diff.max()))
    return err


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


def tile_pairs(shapes, boxes, valid, level, scales, tile=(bwd_kernel.TILE_H, bwd_kernel.TILE_W),
               **kw) -> Tuple[int, int]:
    """(bin-tile pairs, terms) of the plain backward on these inputs: the
    tiles of its level that each bin's cells meet (the bins the kernel
    queues; each reads the bin's g row once), and its (bin, cell) terms."""
    output_size = kw.get("output_size", (7, 7))
    at, rows, _, _, _ = backward_terms(shapes, boxes, valid, level, scales, **kw)
    sizes = torch.tensor([h * w for h, w in shapes])
    starts = torch.cumsum(sizes, 0) - sizes
    lvl = level.long().cpu()[at[:, 0].cpu()]
    local = rows.cpu() - starts[lvl]
    w = torch.tensor([w for _, w in shapes])[lvl]
    tiles_x = -(-w // tile[1])
    y, x = local // w, local % w
    tile_id = starts[lvl] + (y // tile[0]) * tiles_x + x // tile[1]
    bin_id = (at[:, 0].cpu() * output_size[0] + at[:, 1].cpu()) * output_size[1] + at[:, 2].cpu()
    return int(torch.unique(bin_id * int(sizes.sum()) + tile_id).numel()), int(at.shape[0])


def index_add_bwd_ms(grad, shapes, boxes, valid, level, scales, iters: int, **kw) -> float:
    """The library call: one ``index_add_`` of the plain backward's terms
    (their rows and values, made beforehand) into a zeroed f32 map of every
    level."""
    c = grad.shape[-1]
    at, rows, ysum, xsum, count = backward_terms(shapes, boxes, valid, level, scales, **kw)
    gc = grad.float() / count[:, None, None, None]
    p, ph, pw = at[:, :3].unbind(1)
    terms = gc[p, ph, pw] * ysum[:, None] * xsum[:, None]
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


# (tile rows: a warp each, tile columns, bins of g a lane has in flight)
BWD_SWEEP = ((8, 8, 2), (8, 8, 8), (4, 8, 4), (8, 4, 4), (16, 8, 4), (4, 4, 4))


def bwd_sweep_source(tile_h: int, tile_w: int, depth: int) -> pathlib.Path:
    """A copy of the current backward source with other tile and prefetch
    constants, written under build/ for a baseline build."""
    src = (kbuild.CSRC_DIR / "roi_align_bwd.cu").read_text()
    for name, val in (("kTileH", tile_h), ("kTileW", tile_w), ("kDepth", depth)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};", src)
        if n != 1:
            raise RuntimeError(f"no single constant {name} in roi_align_bwd.cu")
    out = kbuild.BUILD_DIR / "sweep" / f"roi_align_bwd_{tile_h}x{tile_w}d{depth}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def _old_bwd_interface(path) -> bool:
    """Whether a backward source has the earlier C interface, which takes a
    zeroed f32 accumulator beside the output: 19 parameters against 18."""
    m = re.search(r"int sos_roi_align_bwd\(([^)]*)\)", pathlib.Path(path).read_text())
    return m is not None and m.group(1).count(",") == 18


def _old_bwd(lib, grad, shapes, boxes, valid, level, scales, *, sampling_ratio=0,
             aligned=True, sample_cap=8):
    """The adapter: the earlier kernel on a zeroed f32 accumulator, cast to
    bf16 by its second kernel."""
    p, ph, pw, c = grad.shape
    sizes = [h * w * c for h, w in shapes]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=grad.device)
    out = acc if grad.dtype == torch.float32 else torch.empty(sum(sizes), dtype=grad.dtype,
                                                             device=grad.device)
    n = len(shapes)
    err = lib.sos_roi_align_bwd(
        kernel.DTYPES[grad.dtype], n, (ctypes.c_int * n)(*[h for h, _ in shapes]),
        (ctypes.c_int * n)(*[w for _, w in shapes]),
        (ctypes.c_float * n)(*[float(x) for x in scales]), c, boxes.data_ptr(),
        level.data_ptr(), valid.data_ptr(), p, ph, pw, sampling_ratio,
        sampling_ratio if sampling_ratio > 0 else sample_cap, int(aligned), grad.data_ptr(),
        acc.data_ptr(), None if out is acc else out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline backward: CUDA error {err}")
    return [t.view(h, w, c) for t, (h, w) in zip(out.split(sizes), shapes)]


def _bind_old(path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_roi_align_bwd.argtypes = [ci, ci, vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                                      ci, vp, vp, vp, vp]
    lib.sos_roi_align_bwd.restype = ci
    return lib


def _new_bwd(lib, grad, shapes, boxes, valid, level, scales, *, sampling_ratio=0, aligned=True,
             sample_cap=8):
    """A build with the current C interface, outside the wrapper's count."""
    c = grad.shape[-1]
    sizes = [h * w * c for h, w in shapes]
    out = torch.empty(sum(sizes), dtype=grad.dtype, device=grad.device)
    bwd_kernel.launch(lib, grad, shapes, boxes, valid, level, scales, out,
                      sampling_ratio=sampling_ratio,
                      cap=sampling_ratio if sampling_ratio > 0 else sample_cap, aligned=aligned)
    return [t.view(h, w, c) for t, (h, w) in zip(out.split(sizes), shapes)]


def bwd_builds(baselines: Sequence[str] = (), sweep: bool = False) -> Dict[str, tuple]:
    """label -> (backward with the wrapper's signature, exact): each
    LABEL=PATH baseline (an earlier source with the atomics' C interface
    runs through the adapter and is not exact), the sweep's variants, then
    the current source. They launch the libraries directly, so they leave
    the wrapper's launch count alone."""
    specs = [spec.split("=", 1) for spec in baselines]
    if sweep:
        specs += [(f"{th}x{tw}d{dp}", str(bwd_sweep_source(th, tw, dp)))
                  for th, tw, dp in BWD_SWEEP]
    specs.append(("current", None))
    with ThreadPoolExecutor(len(specs)) as ex:   # one nvcc each, all at once
        paths = list(ex.map(lambda sp: kbuild.build(f"roi_align_bwd_{sp[0]}" if sp[1] else
                                                    "roi_align_bwd", sp[1]), specs))
    out = {}
    for (label, src), path in zip(specs, paths):
        if src and _old_bwd_interface(src):
            out[label] = (functools.partial(_old_bwd, _bind_old(path)), False)
        else:
            out[label] = (functools.partial(_new_bwd, bwd_kernel.bind(path)), True)
    return out


def run_bwd(device, iters: int = 20, seed: int = 0, baselines: Sequence[str] = (),
            sweep: bool = False) -> Dict[str, dict]:
    """Check and time the backward at both canvases and dtypes; returns
    {"<canvas> <dtype>": {ms, device_ms, plain_ms, library_ms, max_abs_err,
    bound_ms, bound_by, tile_pairs, turns, ...}}. Every build is checked
    first (``check_bwd``, or ``check_bwd_close`` for an earlier atomic one).
    ``ms`` is the wrapper as a caller waits for it, ``device_ms`` the
    current build's device time (the median of its turns); ``turns`` holds
    every build's times in turns, "call" (``cuda_ms``) and "device"
    (``device_ms``)."""
    builds = bwd_builds(baselines, sweep)
    out = {}
    for canvas, image_hw in ((CANVAS, IMAGE_HW), (TOP_CANVAS, TOP_IMAGE_HW)):
        for dtype in (torch.bfloat16, torch.float32):
            args = bwd_inputs(device, dtype, seed, canvas, image_hw)
            err = check_bwd(*args)
            for label, (fn, exact) in builds.items():
                (check_bwd if exact else check_bwd_close)(*args, fn=fn)
            ms = cuda_ms(lambda: bwd_kernel.roi_align_bwd_cuda(*args), iters)
            fns = {label: functools.partial(fn, *args) for label, (fn, _) in builds.items()}
            turns = {"call": in_turns(fns, iters, cuda_ms),
                     "device": in_turns(fns, iters, device_ms)}
            grad = args[0]
            plain_ms = cuda_ms(lambda: roi_align_levels_backward_reference(
                grad.permute(0, 3, 1, 2), *args[1:]), 3)
            lib_ms = index_add_bwd_ms(*args, iters=iters)
            pairs, terms = tile_pairs(*args[1:])
            per_level = torch.bincount(args[4][args[3]].long(), minlength=len(STRIDES)).tolist()
            out[f"{canvas[0]}x{canvas[1]} {str(dtype)[6:]}"] = {
                "max_abs_err": err, "ms": ms,
                "device_ms": float(np.median(turns["device"]["current"])),
                "plain_ms": plain_ms, "library_ms": lib_ms, "rois_per_level": per_level,
                "tile_pairs": pairs, "terms": terms, "turns": turns, **bwd_bounds(*args)}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH: another source of the kernel, timed in turns")
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    ap.add_argument("--sweep", action="store_true",
                    help="with --kernel bwd: also time the backward at other tile sizes and "
                         "warps a block")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    if args.kernel == "bwd":
        res = run_bwd(torch.device("cuda", 0), args.iters, args.seed, args.baseline, args.sweep)
        for name, r in res.items():
            print(f"[roi_align_bwd] {name} x {CHANNELS}, P={TRAIN_ROIS} (per level "
                  f"{r['rois_per_level']}, {r['samples']} samples, {r['terms']} terms, "
                  f"{r['tile_pairs']} bin-tile pairs): bit-identical to the plain backward on "
                  f"the CPU and across two launches; kernel {r['ms']:.4f} ms as called, "
                  f"{r['device_ms']:.4f} ms device; bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']} ({100 * r['bound_ms'] / r['device_ms']:.1f}% of the device "
                  f"time; bytes {r['bytes_bound_ms']:.4f}, operations {r['ops_bound_ms']:.4f}); "
                  f"plain {r['plain_ms']:.3f} ms; index_add_ {r['library_ms']:.3f} ms | {card}",
                  flush=True)
            for kind, times in r["turns"].items():
                print(f"[roi_align_bwd] {name} in turns, {kind}: {fmt_turns(times)}", flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            for name, (a, kw) in bwd_adversarial_cases(torch.device("cuda", 0), dtype,
                                                       args.seed).items():
                check_bwd(*a, **kw)
                print(f"[roi_align_bwd] {str(dtype)[6:]} {name}: bit-identical to the plain "
                      f"backward", flush=True)
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
