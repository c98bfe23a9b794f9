"""ctypes binding of the CUDA multi-level ROIAlign backward
(``csrc/roi_align_bwd.cu``), and its launch plan.

The kernel walks each level's gradient in tiles of ``TILE_H`` x ``TILE_W``
cells and ``SLICE`` channels, one block each (a warp for each row of the
tile, a lane for ``VEC`` channels of it, and one warp that queues the bins
meeting the tile with their row and column tables), sums each tile in
registers in ascending bin order and writes it once: no atomics, the same
result every run, bit-identical to the plain backward on the CPU
(``ops/roi_align.py:roi_align_levels_backward_reference``).

The wrapper validates its inputs, allocates the gradient with
``torch.empty`` (the kernel writes every element), launches on PyTorch's
current stream, and returns each level's (H_l, W_l, C) gradient as a view
of one buffer that holds the levels after one another. It raises on
anything the kernel does not take (more than ``MAX_BINS`` output rows or
columns, a sample cap above ``MAX_CAP``) and when the launch reports an
error; it never falls back to the plain version. ``launches`` counts the
calls that launched the kernel in this process. ``launch_plan`` gives the
tile, slice, shared memory and grid from the constants below, which mirror
the source's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from .build import build
from .roi_align import DTYPES, MAX_LEVELS, SM_SMEM, SMEM_LIMIT
from .roi_pool import check_arg

launches = 0

# the build's constants, as in csrc/roi_align_bwd.cu
TILE_H, TILE_W, VEC, DEPTH, QUEUE, TABLES, ROIS = 8, 8, 4, 4, 256, 64, 4
MAX_BINS = 16        # output rows (and columns) at most: a ROI's tables fit a warp's lanes
MAX_CAP = 4096       # samples a side at most: the sample count stays an exact f32
SLICE = 32 * VEC     # channels a block, VEC a lane (32 where C is not a multiple of VEC)
THREADS = TILE_H * 32 + 32   # a warp for each tile row and the warp that fills the queues
MIN_BLOCKS = 864 // THREADS  # blocks an SM holds by the launch bounds: 27 warps
OPS_PER_SAMPLE = 8   # f32 operations a sample-channel of the transpose: 4 products, 4 adds


def smem_bytes(tile_h: int = TILE_H, tile_w: int = TILE_W, depth: int = DEPTH) -> int:
    """sizeof(Smem) for these constants: each lane's ring of ``depth``
    16-byte g slots, two queues of bins (16 bytes each), of tables (a float
    a cell of the tile's longer side and a mask, in 16-byte units) and of
    each tile row's list of bins (2 bytes a bin, and its length), the
    filling warp's list of ROIs (32 bytes each), the boxes, levels and
    candidate places of the ROIs it tests (24 bytes each) and (ph, pw) of
    each bin, and the queues' last flags."""
    tab = -(-(4 * max(tile_h, tile_w) + 4) // 16) * 16
    size = (tile_h * depth * 32 * 16 + 2 * QUEUE * 16 + 2 * TABLES * tab
            + 2 * tile_h * (2 * QUEUE + 4) + 32 * ROIS * (32 + 24) + 4 * MAX_BINS * MAX_BINS
            + 8)
    return -(-size // 16) * 16


def tiles(shapes: Sequence[Tuple[int, int]], tile=(TILE_H, TILE_W)) -> int:
    """Tiles of all levels."""
    return sum(-(-h // tile[0]) * -(-w // tile[1]) for h, w in shapes)


def launch_plan(shapes: Sequence[Tuple[int, int]], c: int) -> dict:
    """Tile, channel slice, threads, shared memory bytes, blocks and resident
    blocks an SM (those the launch bounds ask for, within the SM's shared
    memory) of the launch for levels of ``shapes`` and ``c`` channels:
    one block for each tile of each level and each slice, the slices of a
    tile side by side. The shared memory does not depend on the inputs."""
    smem = smem_bytes()
    sl = SLICE if c % VEC == 0 else 32
    return {"tile": (TILE_H, TILE_W), "slice": sl, "threads": THREADS, "smem_bytes": smem,
            "blocks": tiles(shapes) * -(-c // sl), "fits": smem <= SMEM_LIMIT,
            "blocks_per_sm": min(SM_SMEM // (smem + 1024), MIN_BLOCKS)}


def traffic_bytes(shapes: Sequence[Tuple[int, int]], c: int, p: int, element_size: int,
                  output_size=(7, 7)) -> int:
    """Bytes the function must move: the output gradient g read once, every
    level's gradient written once, the boxes, levels and valid flags read
    once."""
    cells = sum(h * w for h, w in shapes)
    return (p * output_size[0] * output_size[1] * c * element_size + cells * c * element_size
            + p * (16 + 4 + 1))


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with this kernel's C interface
    (``sos_roi_align_bwd``) and declare its argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_roi_align_bwd.argtypes = [ci, ci, vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                                      ci, vp, vp, vp]
    lib.sos_roi_align_bwd.restype = ci
    lib.sos_roi_align_bwd_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.sos_roi_align_bwd_config.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("roi_align_bwd"))


def library_config(lib=None) -> dict:
    """The constants a built library reports."""
    out = (ctypes.c_int * 9)()
    (lib or _lib()).sos_roi_align_bwd_config(out)
    return {"tile": (out[0], out[1]), "slice": out[2], "threads": out[3], "smem_bytes": out[4],
            "queue": out[5], "tables": out[6], "max_bins": out[7], "max_cap": out[8]}


def launch(lib: ctypes.CDLL, grad: torch.Tensor, shapes: Sequence[Tuple[int, int]],
           boxes: torch.Tensor, valid: torch.Tensor, level: torch.Tensor,
           spatial_scales: Sequence[float], out: torch.Tensor, *, sampling_ratio: int,
           cap: int, aligned: bool) -> None:
    """Launch ``lib``'s kernel on PyTorch's current stream into ``out``, the
    levels' gradients after one another; the arguments are those the
    wrapper has checked. Raises when the launch reports an error."""
    p, ph, pw, c = grad.shape
    n = len(shapes)
    hs = (ctypes.c_int * n)(*[h for h, _ in shapes])
    ws = (ctypes.c_int * n)(*[w for _, w in shapes])
    scales = (ctypes.c_float * n)(*[float(s) for s in spatial_scales])
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = lib.sos_roi_align_bwd(
            DTYPES[grad.dtype], n, hs, ws, scales, c, boxes.data_ptr(), level.data_ptr(),
            valid.data_ptr(), p, ph, pw, sampling_ratio, cap, int(aligned), grad.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_align_bwd_cuda: kernel launch failed with CUDA error {err}")


def roi_align_bwd_cuda(grad: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                       boxes: torch.Tensor, valid: torch.Tensor, level: torch.Tensor,
                       spatial_scales: Sequence[float], *, sampling_ratio: int = 0,
                       aligned: bool = True, sample_cap: int = 8) -> List[torch.Tensor]:
    """Launch the kernel. grad: (P, PH, PW, C) float32 or bfloat16,
    contiguous, on a CUDA device, the gradient of ``roi_align_fwd_cuda``'s
    output; shapes: (H_l, W_l) of 1 to 8 levels; boxes (P, 4) float32; valid
    (P,) bool; level (P,) int32 in [0, levels) (not checked: that would cost
    a device sync; an index outside is clamped). Returns each level's (H_l,
    W_l, C) gradient in grad's dtype."""
    global launches
    fn = "roi_align_bwd_cuda"
    if not shapes or len(shapes) > MAX_LEVELS:
        raise ValueError(f"{fn}: 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    if len(spatial_scales) != len(shapes):
        raise ValueError(f"{fn}: {len(spatial_scales)} scales for {len(shapes)} levels")
    if not grad.is_cuda:
        raise ValueError(f"{fn}: grad must be a CUDA tensor, got {grad.device}")
    if grad.dtype not in DTYPES or grad.dim() != 4:
        raise ValueError(f"{fn}: grad must be (P, PH, PW, C) float32 or bfloat16, got "
                         f"{grad.dtype} {tuple(grad.shape)}")
    p, ph, pw, c = grad.shape
    dev = grad.device
    check_arg(fn, "grad", grad, grad.dtype, (p, ph, pw, c), dev)
    check_arg(fn, "boxes", boxes, torch.float32, (p, 4), dev)
    check_arg(fn, "valid", valid, torch.bool, (p,), dev)
    check_arg(fn, "level", level, torch.int32, (p,), dev)
    if boxes.data_ptr() % 16:
        raise ValueError(f"{fn}: boxes must start at a 16-byte aligned address")
    if not (1 <= ph <= MAX_BINS and 1 <= pw <= MAX_BINS and c >= 1):
        raise ValueError(f"{fn}: output size {(ph, pw)} outside [1, {MAX_BINS}] or no channels")
    cap = sampling_ratio if sampling_ratio > 0 else sample_cap
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"{fn}: sample cap {cap} outside [1, {MAX_CAP}]")
    for h, w in shapes:
        if h < 1 or w < 1:
            raise ValueError(f"{fn}: level of shape {(h, w)}")
    if grad.numel() >= 2**31 or launch_plan(shapes, c)["blocks"] >= 2**31:
        raise ValueError(f"{fn}: shape exceeds the kernel's index range")
    sizes = [h * w * c for h, w in shapes]
    out = torch.empty(sum(sizes), dtype=grad.dtype, device=dev)
    launch(_lib(), grad, shapes, boxes, valid, level, spatial_scales, out,
           sampling_ratio=sampling_ratio, cap=cap, aligned=aligned)
    launches += 1
    return [g.view(h, w, c) for g, (h, w) in zip(out.split(sizes), shapes)]
