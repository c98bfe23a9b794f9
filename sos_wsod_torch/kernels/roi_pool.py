"""ctypes binding of the CUDA ROIPool forward (``csrc/roi_pool_fwd.cu``).

The wrapper validates its inputs, allocates the outputs with ``torch.empty``
and launches on PyTorch's current stream. It raises on anything the kernel
does not take and when the launch reports an error; it never falls back to
the plain version. ``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import build

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with this kernel's C interface
    (``sos_roi_pool_fwd``) and declare its argument types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.sos_roi_pool_fwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
    fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("roi_pool_fwd"))


def launch(lib: ctypes.CDLL, feat, hs, he, ws, we, valid, row_scale, out, pos) -> None:
    """Launch ``lib``'s kernel on PyTorch's current stream into the
    preallocated ``out`` and ``pos`` (or None); the arguments are those the
    wrapper has checked. Raises when the launch reports an error."""
    h, w, c = feat.shape
    p, ph = hs.shape
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.sos_roi_pool_fwd(
            DTYPES[feat.dtype], feat.data_ptr(), h, w, c,
            hs.data_ptr(), he.data_ptr(), ws.data_ptr(), we.data_ptr(),
            valid.data_ptr(), None if row_scale is None else row_scale.data_ptr(),
            p, ph, ws.shape[1], out.data_ptr(), None if pos is None else pos.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_fwd_cuda: kernel launch failed with CUDA error {err}")


def check_arg(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``; ``fn`` names the wrapper in the message."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def roi_pool_fwd_cuda(feat: torch.Tensor, hs: torch.Tensor, he: torch.Tensor,
                      ws: torch.Tensor, we: torch.Tensor, valid: torch.Tensor,
                      row_scale: Optional[torch.Tensor] = None, *,
                      return_argmax: bool = True):
    """Launch the kernel. feat (H, W, C) float32 or bfloat16 on a CUDA device;
    hs/he (P, PH) and ws/we (P, PW) int32 bin windows from
    ``ops.roi_pool.bin_windows``; valid (P,) bool; row_scale (P,) float32 or
    None. Returns (out (P, PH, PW, C) feat.dtype, pos (P, PH, PW, C) int32 or
    None when ``return_argmax`` is False)."""
    global launches
    if not feat.is_cuda:
        raise ValueError(f"roi_pool_fwd_cuda: feat must be a CUDA tensor, got {feat.device}")
    if feat.dtype not in DTYPES:
        raise ValueError(f"roi_pool_fwd_cuda: unsupported feature dtype {feat.dtype}")
    if feat.dim() != 3 or not feat.is_contiguous():
        raise ValueError("roi_pool_fwd_cuda: feat must be a contiguous (H, W, C) tensor")
    h, w, c = feat.shape
    p, ph = hs.shape
    pw = ws.shape[1]
    dev = feat.device
    for name, t, shape in (("hs", hs, (p, ph)), ("he", he, (p, ph)),
                           ("ws", ws, (p, pw)), ("we", we, (p, pw))):
        check_arg("roi_pool_fwd_cuda", name, t, torch.int32, shape, dev)
    check_arg("roi_pool_fwd_cuda", "valid", valid, torch.bool, (p,), dev)
    if row_scale is not None:
        check_arg("roi_pool_fwd_cuda", "row_scale", row_scale, torch.float32, (p,), dev)
    if h * w >= 2**31 or p * ph * pw >= 2**31 or ph > 65535:
        raise ValueError("roi_pool_fwd_cuda: shape exceeds the kernel's index range")

    out = torch.empty((p, ph, pw, c), dtype=feat.dtype, device=dev)
    pos = torch.empty((p, ph, pw, c), dtype=torch.int32, device=dev) if return_argmax else None
    if p == 0:
        return out, pos
    launch(_lib(), feat, hs, he, ws, we, valid, row_scale, out, pos)
    launches += 1
    return out, pos
