"""ctypes binding of the CUDA multi-level ROIAlign forward
(``csrc/roi_align_fwd.cu``), and its launch plan.

The wrapper validates its inputs, allocates the output with ``torch.empty``
and launches on PyTorch's current stream. It raises on anything the kernel
does not take and when the launch reports an error; it never falls back to
the plain version. ``launches`` counts the kernel launches of this process.

The kernel gives one block to each ROI and group of ``SLICES_PER_BLOCK``
channel slices of ``SLICE_BYTES``, and stages the ROI's window of each
slice in shared memory when it fits (the staged branch), else reads the
corners from the map (the direct branch). ``launch_plan`` gives the slice,
threads, shared memory and grid from the constants below, which mirror the
source's; ``roi_geometry`` repeats, in torch, the kernel's per-ROI
arithmetic that picks the branch, so that a test can count the ROIs that
take each.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from .build import build
from .roi_pool import check_arg

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8   # kMaxLevels in csrc/roi_align_fwd.cu

# the build's constants, as in csrc/roi_align_fwd.cu
THREADS, SLICE_BYTES, BUFFER_BYTES, TABLE, BLOCKS_PER_SM = 256, 128, 73728, 64, 3
SLICES_PER_BLOCK = 2     # channel slices of one ROI a block takes in turn
VEC_BYTES = 16           # channels a thread reads at a time, in bytes
AXIS_BYTES = 16          # sizeof(Axis): two int offsets, two float factors
SMEM_LIMIT = 232448      # bytes of shared memory a block may use on Hopper
SM_SMEM = 233472         # an SM's shared memory (228 KB), 1 KB of it kept for each block
OPS_PER_SAMPLE = 9       # f32 operations a sample-channel: 4 products, 4 adds, the accumulate


def smem_bytes() -> int:
    """sizeof(Smem): the two sample tables, each warp's window extremes and
    the window buffer (one window, or two of half the size)."""
    return 2 * TABLE * AXIS_BYTES + (THREADS // 32) * 4 * 4 + BUFFER_BYTES


def launch_plan(c: int, element_size: int, p: int) -> dict:
    """Channel slice, threads, shared memory bytes, blocks and resident
    blocks an SM of the launch for ``p`` ROIs of ``c`` channels: one block
    for each ROI and group of ``SLICES_PER_BLOCK`` slices. The shared memory
    is the same for every input: a window that does not fit takes the
    direct branch, never a larger block."""
    sl = SLICE_BYTES // element_size
    smem = smem_bytes()
    slices = -(-c // sl)
    return {"slice": sl, "threads": THREADS, "smem_bytes": smem,
            "blocks": p * -(-slices // SLICES_PER_BLOCK),
            "fits": smem <= SMEM_LIMIT, "blocks_per_sm": SM_SMEM // (smem + 1024)}


def traffic_bytes(features: Sequence[torch.Tensor], p: int, output_size=(7, 7)) -> int:
    """Bytes the function must move: every level's map read once, the
    output written once, the boxes, levels and valid flags read once."""
    isz = features[0].element_size()
    c = features[0].shape[-1]
    maps = sum(f.shape[0] * f.shape[1] for f in features) * c * isz
    return maps + p * output_size[0] * output_size[1] * c * isz + p * (16 + 4 + 1)


def axis_cells(v: torch.Tensor, n: torch.Tensor):
    """_bilinear_weights along one axis, as the kernel's ``axis_cells``: f32
    positions ``v`` on an axis of ``n`` cells (int32, broadcastable) -> the
    two cells (int32) and the factors (l, 1 - l), both +0 out of bounds."""
    oob = (v < -1.0) | (v > n.float())
    v = v.clamp(min=0.0)
    lo = torch.minimum(v.to(torch.int32), n - 1)
    hi = torch.minimum(lo + 1, n - 1)
    v = torch.where(lo >= n - 1, (n - 1).float(), v)
    low = v - lo.float()
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    return lo, hi, torch.where(oob, zero, low), torch.where(oob, zero, 1.0 - low)


def sample_positions(start: torch.Tensor, bin_size: torch.Tensor, grid: torch.Tensor,
                     bins: int, cap: int) -> torch.Tensor:
    """(P, bins, cap) f32 sample positions along one axis, as the kernel's
    ``sample_pos``: (start + p * bin) + ((i + 0.5) / grid) * bin; the
    entries i >= grid are computed too, and are not samples."""
    idx = torch.arange(bins, dtype=torch.float32, device=start.device)
    half = torch.arange(cap, dtype=torch.float32, device=start.device) + 0.5
    frac = half[None, :] / grid.float()[:, None]                               # (P, cap)
    first = start[:, None] + idx[None, :] * bin_size[:, None]                  # (P, bins)
    return first[:, :, None] + frac[:, None, :] * bin_size[:, None, None]


def roi_geometry(shapes: Sequence[Tuple[int, int]], boxes: torch.Tensor, valid: torch.Tensor,
                 level: torch.Tensor, spatial_scales: Sequence[float], *,
                 output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                 aligned: bool = True, sample_cap: int = 8, wide: bool = True,
                 buffer_bytes: int = BUFFER_BYTES) -> Dict[str, torch.Tensor]:
    """The kernel's per-ROI quantities, in the kernel's f32 operations:
    scaled box (x1, y1), bin sizes, grid, the window's rows [y0, y1] and
    columns [x0, x1] (over every sample of the grid, out-of-bounds ones
    included), its cells,
    ``unit``: bytes a staged cell (128 where ``wide`` 16-byte chunks fit,
    else 64; 0 where the window does not fit ``buffer_bytes``), ``staged``:
    the ROI is valid, the tables hold its sample rows and columns and its
    window fits; and ``two_buffers``: staged, in half the buffer. shapes:
    (H_l, W_l) of each level."""
    dev = boxes.device
    ph_out, pw_out = output_size
    cap = sampling_ratio if sampling_ratio > 0 else sample_cap
    p = boxes.shape[0]
    lvl = level.long().clamp(0, len(shapes) - 1)
    h = torch.tensor([s[0] for s in shapes], dtype=torch.int32, device=dev)[lvl]
    w = torch.tensor([s[1] for s in shapes], dtype=torch.int32, device=dev)[lvl]
    scale = torch.tensor(spatial_scales, dtype=torch.float32, device=dev)[lvl]
    scaled = boxes.float() * scale[:, None] - (0.5 if aligned else 0.0)
    roi_w = scaled[:, 2] - scaled[:, 0]
    roi_h = scaled[:, 3] - scaled[:, 1]
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    bin_h = roi_h / torch.full_like(roi_h, ph_out)
    bin_w = roi_w / torch.full_like(roi_w, pw_out)
    if sampling_ratio > 0:
        grid_h = grid_w = torch.full((p,), sampling_ratio, dtype=torch.int32, device=dev)
    else:
        grid_h = torch.ceil(bin_h).to(torch.int32).clamp(1, cap)
        grid_w = torch.ceil(bin_w).to(torch.int32).clamp(1, cap)
    y = sample_positions(scaled[:, 1], bin_h, grid_h, ph_out, cap)
    x = sample_positions(scaled[:, 0], bin_w, grid_w, pw_out, cap)
    ylo, yhi, _, _ = axis_cells(y, h[:, None, None])
    xlo, xhi, _, _ = axis_cells(x, w[:, None, None])
    big = torch.iinfo(torch.int32).max
    in_y = torch.arange(cap, device=dev)[None, None, :] < grid_h[:, None, None]
    in_x = torch.arange(cap, device=dev)[None, None, :] < grid_w[:, None, None]
    y0 = torch.where(in_y, ylo, big).flatten(1).amin(1)
    y1 = torch.where(in_y, yhi, -big).flatten(1).amax(1)
    x0 = torch.where(in_x, xlo, big).flatten(1).amin(1)
    x1 = torch.where(in_x, xhi, -big).flatten(1).amax(1)
    cells = (y1 - y0 + 1).long() * (x1 - x0 + 1).long()
    tables = (ph_out * grid_h.long() <= TABLE) & (pw_out * (grid_w.long() | 1) <= TABLE)
    unit = torch.where(cells * 64 <= buffer_bytes, 64, 0)
    if wide:
        unit = torch.where(cells * 128 <= buffer_bytes, 128, unit)
    staged = valid & tables & (unit > 0)
    return {"x1": scaled[:, 0], "y1": scaled[:, 1], "bin_h": bin_h, "bin_w": bin_w,
            "grid_h": grid_h, "grid_w": grid_w, "h": h, "w": w, "cap": cap,
            "window": torch.stack([y0, y1, x0, x1], 1), "cells": cells,
            "unit": torch.where(staged, unit, 0), "staged": staged,
            "two_buffers": staged & (2 * cells * unit <= buffer_bytes)}


def operations(grid_h: torch.Tensor, grid_w: torch.Tensor, valid: torch.Tensor, c: int,
               output_size=(7, 7)) -> int:
    """f32 operations the function does on these inputs: ``OPS_PER_SAMPLE``
    for each channel of each sample of each valid ROI's actual grid."""
    samples = int((grid_h.long() * grid_w.long() * valid).sum()) * output_size[0] * output_size[1]
    return samples * c * OPS_PER_SAMPLE


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with this kernel's C interface
    (``sos_roi_align_fwd``) and declare its argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_roi_align_fwd.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, ci, ci,
                                      ci, ci, ci, vp, vp]
    lib.sos_roi_align_fwd.restype = ci
    if hasattr(lib, "sos_roi_align_fwd_config"):
        lib.sos_roi_align_fwd_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.sos_roi_align_fwd_config.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("roi_align_fwd"))


def library_config(lib=None) -> dict:
    """The constants a built library reports."""
    out = (ctypes.c_int * 8)()
    (lib or _lib()).sos_roi_align_fwd_config(out)
    return dict(zip(("threads", "slice_bytes", "buffer_bytes", "table", "blocks_per_sm",
                     "smem_bytes", "slices_per_block", "vec_bytes"), out))


def launch(lib: ctypes.CDLL, features, boxes, valid, level, spatial_scales, out, *,
           sampling_ratio: int, cap: int, aligned: bool) -> None:
    """Launch ``lib``'s kernel on PyTorch's current stream into ``out``
    (P, PH, PW, C); the arguments are those the wrapper has checked. Raises
    when the launch reports an error."""
    f0 = features[0]
    p, ph, pw, c = out.shape
    vec = 16 // f0.element_size()
    wide = int(c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (*features, out)))
    n = len(features)
    feats = (ctypes.c_int64 * n)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * n)(*[f.shape[0] for f in features])
    ws = (ctypes.c_int * n)(*[f.shape[1] for f in features])
    scales = (ctypes.c_float * n)(*[float(s) for s in spatial_scales])
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        err = lib.sos_roi_align_fwd(
            DTYPES[f0.dtype], n, feats, hs, ws, scales, c, wide, boxes.data_ptr(),
            level.data_ptr(), valid.data_ptr(), p, ph, pw, sampling_ratio, cap, int(aligned),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_align_fwd_cuda: kernel launch failed with CUDA error {err}")


def roi_align_fwd_cuda(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                       valid: torch.Tensor, level: torch.Tensor,
                       spatial_scales: Sequence[float], *,
                       output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 0,
                       aligned: bool = True, sample_cap: int = 8) -> torch.Tensor:
    """Launch the kernel. features: 1 to 8 levels (H_l, W_l, C), float32 or
    bfloat16, contiguous, on one CUDA device; boxes (P, 4) float32; valid
    (P,) bool; level (P,) int32 in [0, levels) (not checked: that would
    cost a device sync; an index outside is clamped). Returns (P, PH, PW, C)
    in the features' dtype."""
    global launches
    fn = "roi_align_fwd_cuda"
    if not features or len(features) > MAX_LEVELS:
        raise ValueError(f"{fn}: 1 to {MAX_LEVELS} levels, got {len(features)}")
    if len(spatial_scales) != len(features):
        raise ValueError(f"{fn}: {len(spatial_scales)} scales for {len(features)} levels")
    f0 = features[0]
    if not f0.is_cuda:
        raise ValueError(f"{fn}: features must be CUDA tensors, got {f0.device}")
    if f0.dtype not in DTYPES:
        raise ValueError(f"{fn}: unsupported feature dtype {f0.dtype}")
    dev, c = f0.device, f0.shape[-1]
    for i, f in enumerate(features):
        if f.dim() != 3:
            raise ValueError(f"{fn}: level {i} must be (H, W, C), got {tuple(f.shape)}")
        check_arg(fn, f"level {i}", f, f0.dtype, (f.shape[0], f.shape[1], c), dev)
        if f.shape[0] * f.shape[1] * c >= 2**62 or f.shape[0] < 1 or f.shape[1] < 1:
            raise ValueError(f"{fn}: level {i} of shape {tuple(f.shape)} out of range")
    p = boxes.shape[0]
    check_arg(fn, "boxes", boxes, torch.float32, (p, 4), dev)
    check_arg(fn, "valid", valid, torch.bool, (p,), dev)
    check_arg(fn, "level", level, torch.int32, (p,), dev)
    if boxes.data_ptr() % 16:
        raise ValueError(f"{fn}: boxes must start at a 16-byte aligned address")
    ph, pw = output_size
    cap = sampling_ratio if sampling_ratio > 0 else sample_cap
    if ph < 1 or pw < 1 or cap < 1:
        raise ValueError(f"{fn}: output size {output_size} or sample cap {cap} out of range")

    out = torch.empty((p, ph, pw, c), dtype=f0.dtype, device=dev)
    if p == 0:
        return out
    launch(_lib(), features, boxes, valid, level, spatial_scales, out,
           sampling_ratio=sampling_ratio, cap=cap, aligned=aligned)
    launches += 1
    return out
