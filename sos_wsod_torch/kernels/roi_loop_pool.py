"""ctypes binding of the CUDA ROILoopPool forward (``csrc/roi_loop_pool_fwd.cu``).

The wrapper validates its inputs, allocates the outputs with ``torch.empty``
(the kernel writes every element) and launches on PyTorch's current stream.
It raises on anything the kernel does not take and when the launch reports an
error; it never falls back to the plain version. ``launches`` counts the
kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import build
from .roi_pool import DTYPES, check_arg

launches = 0


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with this kernel's C interface
    (``sos_roi_loop_pool_fwd``) and declare its argument types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.sos_roi_loop_pool_fwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
    fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("roi_loop_pool_fwd"))


def roi_loop_pool_fwd_cuda(feat: torch.Tensor, hs: torch.Tensor, he: torch.Tensor,
                           ws: torch.Tensor, we: torch.Tensor, ex: torch.Tensor,
                           valid: torch.Tensor, row_scale: Optional[torch.Tensor] = None, *,
                           return_argmax: bool = True):
    """Launch the kernel. feat (H, W, C) float32 or bfloat16 on a CUDA device;
    hs/he (3P, PH) and ws/we (3P, PW) int32 bin windows and ex (3P, 4) int32
    exclusion rectangles from ``ops.roi_loop_pool.loop_windows``; valid (P,)
    bool; row_scale (P,) float32 or None. Returns (out (3P, PH, PW, C)
    feat.dtype, pos (3P, PH, PW, C) int32 or None when ``return_argmax`` is
    False)."""
    global launches
    if not feat.is_cuda:
        raise ValueError(f"roi_loop_pool_fwd_cuda: feat must be a CUDA tensor, got {feat.device}")
    if feat.dtype not in DTYPES:
        raise ValueError(f"roi_loop_pool_fwd_cuda: unsupported feature dtype {feat.dtype}")
    if feat.dim() != 3 or not feat.is_contiguous():
        raise ValueError("roi_loop_pool_fwd_cuda: feat must be a contiguous (H, W, C) tensor")
    h, w, c = feat.shape
    rows, ph = hs.shape
    pw = ws.shape[1]
    if rows % 3:
        raise ValueError(f"roi_loop_pool_fwd_cuda: {rows} window rows is not 3 x P")
    p = rows // 3
    dev = feat.device
    fn = "roi_loop_pool_fwd_cuda"
    for name, t, shape in (("hs", hs, (rows, ph)), ("he", he, (rows, ph)),
                           ("ws", ws, (rows, pw)), ("we", we, (rows, pw)), ("ex", ex, (rows, 4))):
        check_arg(fn, name, t, torch.int32, shape, dev)
    check_arg(fn, "valid", valid, torch.bool, (p,), dev)
    if row_scale is not None:
        check_arg(fn, "row_scale", row_scale, torch.float32, (p,), dev)
    if h * w >= 2**31 or rows * ph * pw >= 2**31:
        raise ValueError(f"{fn}: shape exceeds the kernel's index range")

    out = torch.empty((rows, ph, pw, c), dtype=feat.dtype, device=dev)
    pos = torch.empty((rows, ph, pw, c), dtype=torch.int32, device=dev) if return_argmax else None
    if p == 0:
        return out, pos
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sos_roi_loop_pool_fwd(
            DTYPES[feat.dtype], feat.data_ptr(), h, w, c, hs.data_ptr(), he.data_ptr(),
            ws.data_ptr(), we.data_ptr(), ex.data_ptr(), valid.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(), p, ph, pw, out.data_ptr(),
            None if pos is None else pos.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
    launches += 1
    return out, pos
