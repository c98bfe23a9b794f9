"""ctypes binding of the CUDA ROILoopPool forward (``csrc/roi_loop_pool_fwd.cu``).

The wrapper validates its inputs, allocates the outputs with ``torch.empty``
(the kernel writes every element) and launches on PyTorch's current stream.
It raises on anything the kernel does not take and when the launch reports an
error; it never falls back to the plain version. ``launches`` counts the
kernel launches of this process, ``branch_launches`` the same launches by the
branch the library reports it took.

The kernel has two branches, chosen in the library from the shape, the type
and the pointers' alignment alone: the staged one cuts the map into tiles
whose regions a block holds in shared memory (512 bytes of channels a cell),
the direct one reads every cell from the map. The constants below are the
source's that the CPU emulation of its walk and the count of the bytes it
stages need (tests/test_torch_roi_loop_pool_scan.py holds them to it).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import build
from .roi_pool import DTYPES, check_arg

launches = 0
branch_launches = {"staged": 0, "direct": 0}
BRANCHES = {-1: "staged", -2: "direct"}   # what sos_roi_loop_pool_fwd returns after a launch

# the source's constants (csrc/roi_loop_pool_fwd.cu)
REGION, MAX_WIN, SPAN, MIN_BLOCKS = 20, 13, 65535, 600
STRIDE = REGION - MAX_WIN + 1    # a tile's cells: it answers the windows whose first cell is there


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


def launch(lib: ctypes.CDLL, feat, hs, he, ws, we, ex, valid, row_scale, out,
           pos) -> Optional[str]:
    """Launch ``lib``'s kernel on PyTorch's current stream into the
    preallocated ``out`` and ``pos`` (or None); the arguments are those the
    wrapper has checked. Returns the branch the library reports ("staged" or
    "direct"; None from a library that reports none, such as an earlier
    version of the kernel). Raises when the launch reports an error."""
    h, w, c = feat.shape
    rows, ph = hs.shape
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = lib.sos_roi_loop_pool_fwd(
            DTYPES[feat.dtype], feat.data_ptr(), h, w, c, hs.data_ptr(), he.data_ptr(),
            ws.data_ptr(), we.data_ptr(), ex.data_ptr(), valid.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(), rows // 3, ph, ws.shape[1],
            out.data_ptr(), None if pos is None else pos.data_ptr(), stream)
    if err > 0:
        raise RuntimeError(f"roi_loop_pool_fwd_cuda: kernel launch failed with CUDA error {err}")
    return BRANCHES.get(err)


def fused_layout(hs, he, ws, we, ex) -> torch.Tensor:
    """Whether 3P rows of windows have the layout the kernel reads, as
    ``ops.roi_loop_pool.loop_windows`` makes it: the frame rows' windows equal
    to the box rows', and the box rows' rectangles (h1, h2, w1, w2) strictly
    inside which no cell lies. A 0-dim bool tensor on the windows' device."""
    p = hs.shape[0] // 3
    win = torch.cat((hs, he, ws, we), 1)
    box = ex[:p]
    return ((win[:p] == win[p:2 * p]).all()
            & ((box[:, 1] - box[:, 0] <= 1) | (box[:, 3] - box[:, 2] <= 1)).all())


def roi_loop_pool_fwd_cuda(feat: torch.Tensor, hs: torch.Tensor, he: torch.Tensor,
                           ws: torch.Tensor, we: torch.Tensor, ex: torch.Tensor,
                           valid: torch.Tensor, row_scale: Optional[torch.Tensor] = None, *,
                           return_argmax: bool = True):
    """Launch the kernel. feat (H, W, C) float32 or bfloat16 on a CUDA device,
    W at most 65535; hs/he (3P, PH) and ws/we (3P, PW) int32 bin windows and
    ex (3P, 4) int32 exclusion rectangles from ``ops.roi_loop_pool.loop_windows``
    (the frame rows' windows the box rows', the box rows' rectangles empty:
    ``fused_layout``, checked here with one wait for the device); valid (P,)
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
    if w > SPAN:
        raise ValueError(f"{fn}: a map {w} cells wide exceeds the kernel's 16-bit offsets "
                         f"({SPAN} cells)")
    if not bool(fused_layout(hs, he, ws, we, ex)):
        raise ValueError(f"{fn}: the frame rows' windows must be the box rows' and the box "
                         f"rows' rectangles must exclude nothing, as loop_windows makes them")

    out = torch.empty((rows, ph, pw, c), dtype=feat.dtype, device=dev)
    pos = torch.empty((rows, ph, pw, c), dtype=torch.int32, device=dev) if return_argmax else None
    if p == 0:
        return out, pos
    branch = launch(_lib(), feat, hs, he, ws, we, ex, valid, row_scale, out, pos)
    launches += 1
    branch_launches[branch] += 1
    return out, pos
