"""ctypes binding of the CUDA ROIPool backward (``csrc/roi_pool_bwd.cu``).

The wrapper validates its inputs, allocates the zeroed f32 accumulator with
``torch.zeros`` and launches on PyTorch's current stream. It raises on
anything the kernel does not take and when the launch reports an error; it
never falls back to the plain version. ``launches`` counts the kernel
launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import build
from .roi_pool import DTYPES, check_arg

launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("roi_pool_bwd")))
    fn = lib.sos_roi_pool_bwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, vp, vp]
    fn.restype = ci
    return lib


def roi_pool_bwd_cuda(g: torch.Tensor, pos: torch.Tensor, rs: Optional[torch.Tensor],
                      h: int, w: int) -> torch.Tensor:
    """Launch the kernel. g (P, PH, PW, C) float32 or bfloat16 and pos
    (P, PH, PW, C) int32 (the forward's argmax, -1 = no gradient) on a CUDA
    device; rs (P,) float32 row scale or None. Returns the f32 (h, w, C)
    accumulator of ``g * rs`` scattered to ``pos``."""
    global launches
    fn = "roi_pool_bwd_cuda"
    if not g.is_cuda:
        raise ValueError(f"{fn}: g must be a CUDA tensor, got {g.device}")
    if g.dtype not in DTYPES:
        raise ValueError(f"{fn}: unsupported cotangent dtype {g.dtype}")
    if g.dim() != 4:
        raise ValueError(f"{fn}: g must be (P, PH, PW, C), got shape {tuple(g.shape)}")
    p, ph, pw, c = g.shape
    dev = g.device
    check_arg(fn, "g", g, g.dtype, g.shape, dev)
    check_arg(fn, "pos", pos, torch.int32, g.shape, dev)
    if rs is not None:
        check_arg(fn, "rs", rs, torch.float32, (p,), dev)
    if h * w * c >= 2**31:
        raise ValueError(f"{fn}: shape exceeds the kernel's index range")

    acc = torch.zeros((h, w, c), dtype=torch.float32, device=dev)
    if p == 0 or c == 0:
        return acc
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sos_roi_pool_bwd(
            DTYPES[g.dtype], g.data_ptr(), pos.data_ptr(),
            None if rs is None else rs.data_ptr(), p, ph, pw, c, acc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
    launches += 1
    return acc
