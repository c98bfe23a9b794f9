"""Microbenchmark: the ROIPool forward kernel at the stage-1 shapes.

    python -m sos_wsod_torch.tools.bench_roi_pool [--baseline LABEL=OLD.cu ...]
        [--iters 20]

The inputs are the main path's at full width (``production_pool_inputs``):
random plain5-sized features with a tie plateau, 4000 proposals padded to
4096 slots with whole-image, sub-cell, corner and sliver boxes, and
objectness scales in [1, 2]. Cases: the 87x119x512 inference canvas in bf16
and f32 and the 152x204x512 top training map in bf16, each with pos (the
training call) and without (the inference call).

Every library is first held bit-identical to the plain version, out and pos,
at each shape and dtype. Then each case is timed by CUDA events (median of
``--iters`` calls) in turns over the libraries: the ``--baseline`` builds
(other sources with the same C interface, e.g. earlier versions of it) and
the current ``csrc/roi_pool_fwd.cu``, then the same in reverse. Each line
gives the times beside the bound, the bytes the function must move (the map,
windows and scales read once, out and pos written once) over the H100's 3.35
TB/s of HBM, and the rate at which the current kernel reads its windows'
cells, which come from L2.
"""
from __future__ import annotations

import argparse
import functools
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import build as kbuild
from ..kernels import roi_pool as kernel
from ..ops.roi_pool import bin_windows, roi_pool_reference
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
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=PATH: another source with the kernel's C interface")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_roi_pool needs a CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"{torch.cuda.get_device_name(0)} | {card}", flush=True)
    libs = {}
    for spec in args.baseline:
        label, path = spec.split("=", 1)
        libs[label] = kernel.bind(kbuild.build(f"roi_pool_fwd_{label}", path))
    libs["current"] = kernel.bind(kbuild.build("roi_pool_fwd"))
    pools = {label: functools.partial(pool, lib) for label, lib in libs.items()}
    labels = list(pools)
    order = labels + labels[::-1]
    results = []
    for hwc, dtype in CASES:
        feat32, boxes, valid, rs = production_pool_inputs(device, hwc)
        h, w, c = hwc
        feat = feat32.to(dtype)
        win = bin_windows(boxes, valid, h, w, 7, 7, 1.0 / 8)
        check(pools, feat, win, valid, rs)
        window_gb = window_cells(*win, valid) * c * feat.element_size() / 1e9
        for with_pos in (True, False):
            times = {label: [] for label in labels}
            for label in order:
                times[label].append(cuda_ms(
                    lambda: pools[label](feat, win, valid, rs, with_pos), args.iters))
            nbytes = fwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, feat.element_size(), with_pos)
            bound = bound_ms(nbytes)
            cur = statistics.median(times["current"])
            res = {"hwc": hwc, "dtype": str(dtype)[6:], "pos": with_pos, "bound_ms": bound,
                   "window_gb": window_gb, "times": times}
            results.append(res)
            print(f"{h}x{w}x{c} {res['dtype']:8s} {'pos' if with_pos else 'no pos':6s} | " +
                  " | ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in v) + " ms"
                             for k, v in times.items()) +
                  f" | bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), current at "
                  f"{100 * bound / cur:.1f}% of it | windows {window_gb:.2f} GB from L2, "
                  f"{window_gb / cur:.2f} TB/s | {card}", flush=True)
    return results


if __name__ == "__main__":
    main()
