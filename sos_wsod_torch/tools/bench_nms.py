"""The greedy NMS kernels (csrc/nms.cu) against their plain version, at the
shapes the port runs them, on one GPU.

    python -m sos_wsod_torch.tools.bench_nms [--iters 20] [--seed 0]
        [--baseline LABEL=OLD_NMS.cu ...]

For each shape of ``SHAPES`` it builds score-sorted problems with chains of
suppression, exact score ties, pairs exactly at the IoU threshold,
duplicates, empty boxes and invalid slots (``nms_case``), checks that the
kernels' keep masks equal the plain fixpoint's bit for bit, and prints the
median device times of the mask kernel and the sweep (the host's time to
launch them hidden behind a spin kernel) and the two as a caller waits for
them, beside the bound and the plain version's time. The bound is the
larger of two: the f32 operations of the pairs these inputs need (each kept
box against every later kept box and one test for each suppressed box,
``kernels/nms.py:OPS_PER_PAIR`` each) over 67 TFLOP/s, and the bytes of boxes and valid flags read once and keep
flags written once over 3.35 TB/s. Beside it, the time the mask words alone would take at
3.35 TB/s, written once and read once (``kernels/nms.py:traffic_bytes``).

A baseline is another source of the two kernels, built and timed in turns
with the current one (baselines, current, then the same in reverse), mask
and sweep each: an earlier version kept for the comparison (``git show
<commit>:sos_wsod_torch/csrc/nms.cu > build/parent/nms.cu``), with this C
interface or the earlier one whose mask kernel took no valid flags and the
f32 threshold. Each is held bit-identical to the plain fixpoint too. The
same inputs feed the CPU emulation of the kernels in
tests/test_torch_nms_plan.py.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import pathlib
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import nms as kernel
from ..ops.nms import greedy_keep_sorted_reference
from .measure import (bound_ms, card_line, cuda_ms, device_ms, fmt_turns, in_turns,
                      ops_bound_ms)

# name -> (problems B, boxes S, IoU threshold)
SHAPES: Dict[str, Tuple[int, int, float]] = {
    "stage-1 inference": (20, 4096, 0.3),    # per-class NMS, models/postprocess.py
    "stage-1 mining": (1, 1024, 0.01),       # mist_mining, 4 times a step
    "stage-2 RPN": (1, 4495, 0.7),           # all levels, 704x960 canvas
    "stage-2 box head": (20, 1000, 0.5),     # per-class NMS of 1000 proposals
}


def _threshold_pair(rng, thr: float, x0: float, y0: float) -> np.ndarray:
    """Two boxes whose IoU is exactly the ratio m / n = thr (a box of width
    n and one of width m inside it, height 1), so the f32 IoU equals the
    threshold rounded to f32."""
    for n in (10, 100):
        m = round(thr * n)
        if m >= 1 and abs(m / n - thr) < 1e-12:
            return np.array([[x0, y0, x0 + n, y0 + 1], [x0, y0, x0 + m, y0 + 1]], np.float32)
    return np.array([[x0, y0, x0 + 10, y0 + 10], [x0, y0, x0 + 10, y0 + 10]], np.float32)


def nms_case(batch: int, s: int, thr: float, seed: int):
    """numpy boxes (B, S, 4) XYXY, scores (B, S) and valid (B, S), in random
    order: a third of each problem in chains whose neighbours overlap just
    above ``thr`` (so greedy keeps every other box, and the plain fixpoint
    needs one iteration a link), pairs exactly at the threshold, duplicates
    and empty boxes, the rest random; scores quantized to 0.05, so many tie;
    about 8% of the slots invalid."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, s, 4), np.float32)
    scores = np.zeros((batch, s), np.float32)
    for b in range(batch):
        rows, sc = [], []
        while len(rows) < s // 3:
            n = int(rng.integers(2, 13))
            w = float(rng.integers(8, 60))
            h = float(rng.integers(8, 60))
            d = w * (1 - thr) / (1 + thr) * 0.9   # IoU(k, k+1) just above thr
            x0, y0 = rng.uniform(0, 900, 2)
            top = rng.uniform(0.5, 1.0)
            for k in range(n):
                rows.append([x0 + k * d, y0, x0 + k * d + w, y0 + h])
                sc.append(top - 0.04 * k)
        while len(rows) < s // 3 + s // 10:
            rows.extend(_threshold_pair(rng, thr, *np.floor(rng.uniform(0, 900, 2))))
            sc.extend([rng.uniform(0, 1)] * 2)
        for _ in range(s // 40):
            x0, y0 = rng.uniform(0, 900, 2)
            rows.extend([[x0, y0, x0 + 20, y0 + 30]] * 2)       # a duplicate
            rows.append([x0, y0, x0, y0 + 5])                   # empty
            sc.extend(rng.uniform(0, 1, 3))
        while len(rows) < s:
            x0, y0 = rng.uniform(0, 900, 2)
            rows.append([x0, y0, x0 + rng.uniform(1, 120), y0 + rng.uniform(1, 120)])
            sc.append(rng.uniform(0, 1))
        perm = rng.permutation(s)
        boxes[b] = np.asarray(rows[:s], np.float32)[perm]
        scores[b] = np.round(np.asarray(sc[:s], np.float32) / 0.05)[perm] * 0.05
    valid = rng.uniform(0, 1, (batch, s)) > 0.08
    return boxes, scores.astype(np.float32), valid


def sorted_inputs(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """The boxes and valid flags in the stable score order of ops/nms.py."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4)).contiguous()
    return b, torch.gather(valid, -1, order).contiguous()


def check(b: torch.Tensor, v: torch.Tensor, thr: float, keep_sorted=None) -> torch.Tensor:
    """Kernels (by default the wrapper's, else ``keep_sorted``) against the
    plain fixpoint on the same sorted inputs; raises unless the keep masks
    are equal. Returns the keep mask."""
    got = (keep_sorted or kernel.nms_keep_sorted_cuda)(b, v, thr)
    want = greedy_keep_sorted_reference(b, v, thr)
    if not torch.equal(got, want):
        raise AssertionError(f"NMS kernel keep mask differs from the plain fixpoint in "
                             f"{int((got != want).sum())} of {got.numel()} boxes")
    return got


def pairs_needed(keep: torch.Tensor, valid: torch.Tensor) -> int:
    """The fewest IoU tests greedy NMS can make on these inputs: each kept
    box against every later kept box (none of them suppresses another), and
    one test for each suppressed valid box (against a kept box that
    suppresses it)."""
    kept = keep.sum(-1)
    return int((kept * (kept - 1) // 2).sum() + (valid & ~keep).sum())


def bounds(batch: int, s: int, pairs: int) -> dict:
    """The least time of the two kernels, by operations and by bytes, which
    of the two binds, and the mask words' own time at the HBM rate."""
    ops_ms = ops_bound_ms(pairs * kernel.OPS_PER_PAIR)
    bytes_ms = bound_ms(batch * s * (16 + 1 + 1))
    return {"pairs": pairs, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "mask_words_ms": bound_ms(kernel.traffic_bytes(batch, s))}


Build = Tuple[Callable, Callable]   # (mask(boxes, valid, thr), sweep(mask, valid))


def _old_interface(path) -> bool:
    """Whether a source has the earlier mask interface (boxes, batch, s,
    f32 threshold, mask, stream): 6 parameters against 9."""
    m = re.search(r"int sos_nms_mask\(([^)]*)\)", pathlib.Path(path).read_text())
    return m is not None and m.group(1).count(",") == 5


def _old_mask(lib, boxes, valid, thr):
    """The adapter: the earlier mask kernel, which takes no valid flags."""
    bsz, s, _ = boxes.shape
    mask = torch.empty((bsz, s, kernel.num_words(s)), dtype=torch.int64, device=boxes.device)
    err = lib.sos_nms_mask(boxes.data_ptr(), bsz, s, float(thr), mask.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline mask kernel: CUDA error {err}")
    return mask


def _new_mask(lib, boxes, valid, thr):
    bsz, s, _ = boxes.shape
    mask = torch.empty((bsz, s, kernel.num_words(s)), dtype=torch.int64, device=boxes.device)
    kernel.launch_mask(lib, boxes, valid, thr, mask)
    return mask


def _sweep(lib, mask, valid):
    keep = torch.empty(valid.shape, dtype=torch.bool, device=valid.device)
    kernel.launch_sweep(lib, mask, valid, keep)
    return keep


def _bind_old(path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_nms_mask.argtypes = [vp, ci, ci, ctypes.c_float, vp, vp]
    lib.sos_nms_mask.restype = ci
    lib.sos_nms_sweep.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.sos_nms_sweep.restype = ci
    return lib


def builds(baselines: Sequence[str] = ()) -> Dict[str, Build]:
    """label -> (mask, sweep) launchers: each LABEL=PATH baseline, then the
    current source. They launch the libraries directly, so they leave the
    wrappers' launch counts alone."""
    specs = [spec.split("=", 1) for spec in baselines] + [("current", None)]
    with ThreadPoolExecutor(len(specs)) as ex:   # one nvcc each, all at once
        paths = list(ex.map(lambda sp: kbuild.build(f"nms_{sp[0]}" if sp[1] else "nms", sp[1]),
                            specs))
    out = {}
    for (label, src), path in zip(specs, paths):
        if src and _old_interface(src):
            lib, mask = _bind_old(path), _old_mask
        else:
            lib, mask = kernel.bind(path), _new_mask
        out[label] = (functools.partial(mask, lib), functools.partial(_sweep, lib))
    return out


def run(device, iters: int = 20, seed: int = 0, shapes=None,
        baselines: Sequence[str] = ()) -> Dict[str, dict]:
    """Check and time every shape; returns {name: {kept, ms, mask_ms,
    sweep_ms, device_ms, plain_ms, bound_ms, bound_by, turns, ...}}. ``ms``
    is the wrappers' two launches as a caller waits for them (the host's
    time to launch included, which is most of it at the small shapes);
    ``mask_ms`` and ``sweep_ms`` the current kernels' device time alone
    (``measure.device_ms``), ``device_ms`` their sum. ``turns`` holds every build's times in turns:
    "call" (mask and sweep from the host, as ``ms``), "mask" and "sweep"
    (device time)."""
    libs = builds(baselines)
    out = {}
    for name, (batch, s, thr) in (shapes or SHAPES).items():
        boxes, scores, valid = (torch.from_numpy(a).to(device) for a in nms_case(batch, s, thr, seed))
        b, v = sorted_inputs(boxes, scores, valid)
        keep = check(b, v, thr)
        for mask_fn, sweep_fn in libs.values():
            check(b, v, thr, lambda b_, v_, t_: sweep_fn(mask_fn(b_, v_, t_), v_))
        ms = cuda_ms(lambda: kernel.nms_keep_sorted_cuda(b, v, thr), iters)
        masks = {label: fns[0](b, v, thr) for label, fns in libs.items()}
        turns = {
            "call": in_turns({label: functools.partial(lambda f, g: g(f(b, v, thr), v), *fns)
                              for label, fns in libs.items()}, iters, cuda_ms),
            "mask": in_turns({label: functools.partial(fns[0], b, v, thr)
                              for label, fns in libs.items()}, iters, device_ms),
            "sweep": in_turns({label: functools.partial(fns[1], masks[label], v)
                               for label, fns in libs.items()}, iters, device_ms)}
        plain_ms = cuda_ms(lambda: greedy_keep_sorted_reference(b, v, thr), 3)
        mask_ms, sweep_ms = (float(np.median(turns[k]["current"])) for k in ("mask", "sweep"))
        out[name] = {"batch": batch, "s": s, "thr": thr, "kept": int(keep.sum()), "ms": ms,
                     "mask_ms": mask_ms, "sweep_ms": sweep_ms, "device_ms": mask_ms + sweep_ms,
                     "plain_ms": plain_ms, "turns": turns,
                     **bounds(batch, s, pairs_needed(keep, v))}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH: another source of the two kernels, timed in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    res = run(device, args.iters, args.seed, baselines=args.baseline)
    for name, r in res.items():
        print(f"[nms] {name} B={r['batch']} S={r['s']} thr={r['thr']}: bit-identical, "
              f"{r['kept']} kept, {r['pairs']} pairs; device ms mask {r['mask_ms']:.4f} + sweep "
              f"{r['sweep_ms']:.4f}, {r['ms']:.4f} ms as called; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({100 * r['bound_ms'] / r['device_ms']:.1f}% of it; operations "
              f"{r['ops_bound_ms']:.4f}, bytes {r['bytes_bound_ms']:.5f}; the mask words "
              f"{r['mask_words_ms']:.4f}), plain {r['plain_ms']:.3f} ms | {card}", flush=True)
        for kind, times in r["turns"].items():
            print(f"[nms] {name} in turns, {kind}: {fmt_turns(times)}", flush=True)
    return res


if __name__ == "__main__":
    main()
