"""Kernel E (the ROILoopPool forward, ``csrc/roi_loop_pool_fwd.cu``) against
its plain version, and its time beside the bound, on one CUDA card.

    python -m sos_wsod_torch.tools.bench_roi_loop_pool [--iters N]

At the production shape (plain5 of a 688 x 917 image, 87 x 119 x 512, 4000
proposals in 4096 slots) in bf16 and f32, and on the adversarial map of
``adversarial_inputs`` (a zero block, a negative block, boxes covering the
image, on its edge, below a cell, empty and invalid; 136 and 3 channels): the
kernel's out and pos ``torch.equal`` to the plain version's with pos and
scale, out without pos, and out without scale. The backward (kernel A bwd
over the 3P rows) bit-identical to the plain backward run on the CPU, and
the same bits from two launches. Times: median CUDA-event ms as called and
on the device (``measure.device_ms``), the plain version's, the backward's,
and the bound: the map, boxes, valid and scales read once, out (and pos)
written once, over the card's HBM rate. Prints one line a case and, last, the
card's line.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..kernels.roi_loop_pool import roi_loop_pool_fwd_cuda
from ..kernels.roi_pool_bwd import roi_pool_bwd_cuda
from ..ops.roi_loop_pool import loop_windows, roi_loop_pool_reference
from ..ops.roi_pool import roi_pool_backward_reference
from .bench_roi_pool import FEAT_HWC, _bits, production_pool_inputs
from .measure import bound_ms, card_line, cuda_ms, device_ms

SCALE = 1.0 / 8


def traffic_bytes(h: int, w: int, c: int, p: int, ph: int, pw: int, itemsize: int,
                  with_pos: bool) -> int:
    """Bytes the function must move: the (h, w, c) map, the (P, 4) f32 boxes,
    valid and the f32 scales read once; the 3P rows of out (and int32 pos)
    written once."""
    return h * w * c * itemsize + p * (16 + 1 + 4) + 3 * p * ph * pw * c * (
        itemsize + (4 if with_pos else 0))


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


def check(feat, win, ex, valid, rs) -> float:
    """Raise unless the kernel equals the plain version bit for bit: out and
    pos with scale, out without pos, and out without scale. Returns the
    largest absolute difference of out (0.0)."""
    out_p, pos_p = roi_loop_pool_reference(feat, *win, ex, valid, rs)
    out_n = roi_loop_pool_reference(feat, *win, ex, valid, None)[0]
    out_k, pos_k = roi_loop_pool_fwd_cuda(feat, *win, ex, valid, rs)
    out_i, none = roi_loop_pool_fwd_cuda(feat, *win, ex, valid, rs, return_argmax=False)
    out_s, _ = roi_loop_pool_fwd_cuda(feat, *win, ex, valid, None, return_argmax=False)
    if none is not None:
        raise AssertionError("roi_loop_pool_fwd_cuda: a call without pos returned one")
    for name, a, b in (("out", _bits(out_k), _bits(out_p)), ("pos", pos_k, pos_p),
                       ("out without pos", _bits(out_i), _bits(out_p)),
                       ("out without scale", _bits(out_s), _bits(out_n))):
        if not torch.equal(a, b):
            raise AssertionError(f"roi_loop_pool_fwd: {name} differs from the plain version in "
                                 f"{int((a != b).sum())} elements, feat {tuple(feat.shape)} "
                                 f"{feat.dtype}")
    return float((out_k.float() - out_p.float()).abs().max())


def check_bwd(g, pos, rs3, win, valid3, h: int, w: int) -> torch.Tensor:
    """Raise unless kernel A bwd over the 3P rows is bit-identical to the
    plain backward run on the CPU and to itself across two launches.
    Returns the kernel's gradient."""
    acc = roi_pool_bwd_cuda(g, pos, rs3, *win, valid3, h, w)
    again = roi_pool_bwd_cuda(g, pos, rs3, *win, valid3, h, w)
    plain = roi_pool_backward_reference(g.cpu(), pos.cpu(), rs3.cpu(), h, w)
    if not torch.equal(_bits(acc), _bits(again)):
        raise AssertionError("roi_loop_pool backward: two launches differ")
    if not torch.equal(_bits(acc.cpu()), _bits(plain)):
        n = int((acc.cpu() != plain).sum())
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


def run(device, iters: int = 20, seed: int = 0) -> Dict[str, dict]:
    """Every check and time; returns the results by case (the production
    shape's "bfloat16" and "float32", the adversarial ones), each with
    max_abs_err, ms (with pos, as called), device_ms, ms_nopos,
    device_ms_nopos, plain_ms, bwd_ms, bound_ms, bound_nopos_ms."""
    res = {}
    feat32, boxes, valid, rs = production_pool_inputs(device, FEAT_HWC, seed)
    h, w, c = FEAT_HWC
    win = loop_windows(boxes, valid, h, w, 7, 7, SCALE)
    p = boxes.shape[0]
    for dtype in (torch.bfloat16, torch.float32):
        feat = feat32.to(dtype)
        err = check(feat, win[:4], win[4], valid, rs)
        g, pos, rs3, valid3 = _backward_inputs(feat, win, valid, rs, seed)
        check_bwd(g, pos, rs3, win[:4], valid3, h, w)
        call = lambda: roi_loop_pool_fwd_cuda(feat, *win, valid, rs)  # noqa: E731
        call_nopos = lambda: roi_loop_pool_fwd_cuda(  # noqa: E731
            feat, *win, valid, rs, return_argmax=False)
        isz = feat.element_size()
        res[str(dtype)[6:]] = {
            "max_abs_err": err, "ms": cuda_ms(call, iters), "device_ms": device_ms(call, iters),
            "ms_nopos": cuda_ms(call_nopos, iters),
            "device_ms_nopos": device_ms(call_nopos, iters),
            "plain_ms": cuda_ms(lambda: roi_loop_pool_reference(feat, *win, valid, rs), 2),
            "bwd_ms": cuda_ms(lambda: roi_pool_bwd_cuda(g, pos, rs3, *win[:4], valid3, h, w),
                              iters),
            "bound_ms": bound_ms(traffic_bytes(h, w, c, p, 7, 7, isz, True)),
            "bound_nopos_ms": bound_ms(traffic_bytes(h, w, c, p, 7, 7, isz, False))}
        del g, pos
    for ch in (136, 3):
        feat32, boxes, valid, rs = adversarial_inputs(device, ch, seed)
        ah, aw, _ = feat32.shape
        win = loop_windows(boxes, valid, ah, aw, 7, 7, SCALE)
        for dtype in (torch.bfloat16, torch.float32):
            feat = feat32.to(dtype)
            err = check(feat, win[:4], win[4], valid, rs)
            g, pos, rs3, valid3 = _backward_inputs(feat, win, valid, rs, seed)
            check_bwd(g, pos, rs3, win[:4], valid3, ah, aw)
            res[f"adversarial C={ch} {str(dtype)[6:]}"] = {
                "max_abs_err": err, "empty_bins": int((pos[..., 0] < 0).sum())}
    return res


def report(res: Dict[str, dict], log=print) -> None:
    h, w, c = FEAT_HWC
    for name, r in res.items():
        if name.startswith("adversarial"):
            log(f"roi_loop_pool_fwd {name}: out and pos equal to the plain version (with pos "
                f"and scale, without pos, without scale; {r['empty_bins']} bins of channel 0 "
                f"at 0 with pos -1); backward bit-identical to the plain backward on the CPU "
                f"and across two launches")
            continue
        log(f"roi_loop_pool_fwd {name} feat {FEAT_HWC} P=4096 -> 3P rows: out and pos equal to "
            f"the plain version (with pos and scale, without pos, without scale); backward "
            f"(A bwd over 3P rows) bit-identical to the plain backward on the CPU and across "
            f"two launches; with pos {r['ms']:.3f} ms as called, {r['device_ms']:.3f} ms "
            f"device (bound {r['bound_ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% of "
            f"the call); without pos {r['ms_nopos']:.3f} / {r['device_ms_nopos']:.3f} ms "
            f"(bound {r['bound_nopos_ms']:.4f} ms); plain {r['plain_ms']:.3f} ms; backward "
            f"{r['bwd_ms']:.3f} ms")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_roi_loop_pool needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    report(run(torch.device("cuda", 0), args.iters, args.seed))
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
