"""ctypes binding of the CUDA ROIPool backward (``csrc/roi_pool_bwd.cu``).

    roi_pool_bwd_cuda(g, pos, rs, hs, he, ws, we, valid, h, w)

The kernel walks the output in tiles of ``TILE_H`` x ``TILE_W`` cells and
``SLICE`` channels, one block each (a warp for each 32 channels),
accumulates each tile in shared memory in ascending bin order and writes it
once: no atomics, the same result every
run, bit-identical to the plain version on the CPU. It finds a tile's bins
from the bin windows, so it takes them beside ``pos``. Precondition: ``pos``
is the forward's argmax for these windows, so each entry lies in its bin's
window or is -1.

The wrapper validates its inputs, allocates the output with ``torch.empty``
(the kernel writes every element) and launches on PyTorch's current stream.
It raises on anything the kernel does not take and when the launch reports an
error; it never falls back to the plain version. ``launches`` counts the
kernel launches of this process. ``launch_plan`` gives the launch's tile,
slice, shared memory and grid for a map, from the constants below, which
mirror the source's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import build
from .roi_pool import DTYPES, check_arg

launches = 0

# the build's constants, as in csrc/roi_pool_bwd.cu
TILE_H, TILE_W, WARPS, ADDS, QUEUE, ROIS = 8, 8, 4, 8, 512, 8
SLICE = WARPS * 32         # channels a block: a warp for each 32
THREADS = SLICE + 32       # and the warp that fills the queues
SMEM_LIMIT = 232448    # bytes of shared memory a block may use on Hopper


def smem_bytes(tile_h: int = TILE_H, tile_w: int = TILE_W, warps: int = WARPS) -> int:
    """sizeof(Smem) for these constants: the f32 tile x slice, two queues
    of bins and scales, their lengths and last flags, and the filling warp's
    list of ROIs, all 4-byte words."""
    return 4 * (tile_h * tile_w * warps * 32 + 4 * QUEUE + 4 + 32 * ROIS)


def launch_plan(h: int, w: int, c: int) -> dict:
    """Tile, channel slice, threads, shared memory bytes and blocks of the
    launch for an (h, w, c) map: one block for each tile and slice, the
    slices of a tile side by side."""
    tiles = -(-h // TILE_H) * -(-w // TILE_W)
    return {"tile": (TILE_H, TILE_W), "slice": SLICE, "threads": THREADS,
            "smem_bytes": smem_bytes(), "blocks": tiles * -(-c // SLICE)}


def tile_incidences(hs, he, ws, we, valid, tile=(TILE_H, TILE_W)) -> int:
    """Bin-tile pairs the kernel visits: for every live bin, the tiles its
    window meets. Each pair reads one g row and one pos row of a slice."""
    live = ((he > hs)[:, :, None] & (we > ws)[:, None, :] & valid[:, None, None])
    ny = ((he - 1).div(tile[0], rounding_mode="floor") - hs.div(tile[0], rounding_mode="floor")
          + 1).long()
    nx = ((we - 1).div(tile[1], rounding_mode="floor") - ws.div(tile[1], rounding_mode="floor")
          + 1).long()
    return int(((ny[:, :, None] * nx[:, None, :]) * live).sum())


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with this kernel's C interface
    (``sos_roi_pool_bwd``) and declare its argument types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.sos_roi_pool_bwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp]
    fn.restype = ci
    lib.sos_roi_pool_bwd_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.sos_roi_pool_bwd_config.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("roi_pool_bwd"))


def library_config(lib=None) -> dict:
    """The constants a built library reports: tile, slice, threads, shared
    memory bytes."""
    out = (ctypes.c_int * 5)()
    (lib or _lib()).sos_roi_pool_bwd_config(out)
    return {"tile": (out[0], out[1]), "slice": out[2], "threads": out[3], "smem_bytes": out[4]}


def launch(lib: ctypes.CDLL, g, pos, rs, hs, he, ws, we, valid, out) -> None:
    """Launch ``lib``'s kernel on PyTorch's current stream into ``out``; the
    arguments are those the wrapper has checked. Raises when the launch
    reports an error."""
    p, ph, pw, c = g.shape
    h, w, _ = out.shape
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.sos_roi_pool_bwd(
            DTYPES[g.dtype], g.data_ptr(), pos.data_ptr(),
            None if rs is None else rs.data_ptr(), hs.data_ptr(), he.data_ptr(),
            ws.data_ptr(), we.data_ptr(), valid.data_ptr(), p, ph, pw, c, h, w,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_pool_bwd_cuda: kernel launch failed with CUDA error {err}")


def roi_pool_bwd_cuda(g: torch.Tensor, pos: torch.Tensor, rs: Optional[torch.Tensor],
                      hs: torch.Tensor, he: torch.Tensor, ws: torch.Tensor, we: torch.Tensor,
                      valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Launch the kernel. g (P, PH, PW, C) float32 or bfloat16 and pos
    (P, PH, PW, C) int32 on a CUDA device; rs (P,) float32 row scale or None;
    hs/he (P, PH) and ws/we (P, PW) int32 bin windows and valid (P,) bool,
    those the forward computed pos from (``ops.roi_pool.bin_windows``).
    Precondition: every entry of pos lies in its bin's window or is -1.
    Returns the f32 (h, w, C) sum of ``g * rs`` at ``pos``."""
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
    for name, t, shape in (("hs", hs, (p, ph)), ("he", he, (p, ph)),
                           ("ws", ws, (p, pw)), ("we", we, (p, pw))):
        check_arg(fn, name, t, torch.int32, shape, dev)
    check_arg(fn, "valid", valid, torch.bool, (p,), dev)
    if h >= 2**16 or w >= 2**16 or h * w >= 2**31 or g.numel() >= 2**31 \
            or launch_plan(h, w, c)["blocks"] >= 2**31:
        raise ValueError(f"{fn}: shape exceeds the kernel's index range")

    if p == 0 or c == 0 or h * w == 0:
        return torch.zeros((h, w, c), dtype=torch.float32, device=dev)
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    launch(_lib(), g, pos, rs, hs, he, ws, we, valid, out)
    launches += 1
    return out
