"""ctypes binding of the CUDA greedy NMS (``csrc/nms.cu``): the suppression
bitmask kernel and the sweep kernel.

The wrappers validate their inputs, allocate the outputs with ``torch.empty``
and launch on PyTorch's current stream. They raise on anything the kernels do
not take and when a launch reports an error; they never fall back to the
plain version. ``mask_launches`` and ``sweep_launches`` count each kernel's
launches in this process.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .build import build
from .roi_pool import check_arg

mask_launches = 0
sweep_launches = 0

TILE = 64   # boxes per mask word (kTile in csrc/nms.cu)
# f32 operations per pair in the mask kernel: 2 fminf, 2 fmaxf and 2
# subtractions for w and h, 2 clamps, the product, the add and the subtract
# of the union, its > 0 test and select, the inter > 0 test. The compare
# against the threshold (2 conversions, a multiply and a compare in f64) is
# not counted.
OPS_PER_PAIR = 14


def num_words(s: int) -> int:
    return -(-s // TILE)


def traffic_bytes(batch: int, s: int) -> int:
    """Bytes the mask words move, with the boxes, valid flags and keep
    flags, for ``batch`` problems of ``s`` boxes: the words on and above the
    diagonal written once and read once by the sweep."""
    w = num_words(s)
    words = TILE * w * (w + 1) // 2
    return batch * (16 * s + s + 2 * 8 * words + s)


@functools.lru_cache(maxsize=64)
def threshold_constants(iou_threshold: float) -> Tuple[float, bool, bool]:
    """The mask kernel's compare for ``thr``: (m, tie_up, zero_suppresses).
    With t = f32(thr) and u the next f32 above it, m = (t + u) / 2 (exact in
    f64), and for inter > 0, f32(inter / safe) > t exactly when inter >
    m * safe, or when they are equal and ``tie_up``: u's significand is even,
    so the tie rounds up to u. ``zero_suppresses`` is 0 > t, the bit of a pair
    whose plain IoU is 0 (inter 0 or NaN)."""
    t = np.float32(iou_threshold)
    zero_suppresses = bool(np.float32(0) > t)
    if math.isnan(t) or t == np.inf:
        return float(t), False, zero_suppresses       # nothing is above
    with np.errstate(over="ignore"):
        u = np.nextafter(t, np.float32(np.inf))
    # past the largest f32 a value rounds to inf as if the next f32 were 2^128
    lo = -2.0 ** 128 if t == -np.inf else float(t)
    hi = 2.0 ** 128 if u == np.inf else float(u)
    tie_up = u == np.inf or int(u.view(np.uint32)) & 1 == 0
    return (lo + hi) / 2, bool(tie_up), zero_suppresses


def bind(path) -> ctypes.CDLL:
    """Load a library built from a source with these kernels' C interface
    (``sos_nms_mask``, ``sos_nms_sweep``) and declare its argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_nms_mask.argtypes = [vp, vp, ci, ci, ctypes.c_double, ci, ci, vp, vp]
    lib.sos_nms_mask.restype = ci
    lib.sos_nms_sweep.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.sos_nms_sweep.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("nms"))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_mask(lib: ctypes.CDLL, boxes, valid, iou_threshold: float, mask) -> None:
    """Launch ``lib``'s mask kernel into the preallocated ``mask``; the
    arguments are those the wrapper has checked."""
    bsz, s, _ = boxes.shape
    m, tie_up, zero_suppresses = threshold_constants(iou_threshold)
    with torch.cuda.device(boxes.device):
        err = lib.sos_nms_mask(boxes.data_ptr(), valid.data_ptr(), bsz, s, m, int(tie_up),
                               int(zero_suppresses), mask.data_ptr(), _stream(boxes.device))
    if err != 0:
        raise RuntimeError(f"nms_mask_words_cuda: kernel launch failed with CUDA error {err}")


def launch_sweep(lib: ctypes.CDLL, mask, valid, keep) -> None:
    """Launch ``lib``'s sweep kernel into the preallocated ``keep``."""
    bsz, s = valid.shape
    with torch.cuda.device(mask.device):
        err = lib.sos_nms_sweep(mask.data_ptr(), valid.data_ptr(), bsz, s, keep.data_ptr(),
                                _stream(mask.device))
    if err != 0:
        raise RuntimeError(f"nms_sweep_cuda: kernel launch failed with CUDA error {err}")


def nms_mask_words_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """Launch the bitmask kernel. boxes (B, S, 4) float32 and valid (B, S)
    bool on a CUDA device, score-sorted -> mask (B, S, ceil(S / 64)) int64
    words (bit t of word w of row i: box i suppresses box 64 w + t), written
    on and above the diagonal in the tiles that hold a valid row and a valid
    column only."""
    global mask_launches
    fn = "nms_mask_words_cuda"
    if not boxes.is_cuda:
        raise ValueError(f"{fn}: boxes must be a CUDA tensor, got {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{fn}: boxes must be (B, S, 4), got {tuple(boxes.shape)}")
    bsz, s, _ = boxes.shape
    check_arg(fn, "boxes", boxes, torch.float32, (bsz, s, 4), boxes.device)
    check_arg(fn, "valid", valid, torch.bool, (bsz, s), boxes.device)
    if boxes.data_ptr() % 16:
        raise ValueError(f"{fn}: boxes must start at a 16-byte aligned address")
    if bsz > 65535 or num_words(s) > 65535:
        raise ValueError(f"{fn}: batch {bsz} or {s} boxes exceed the kernel's grid")
    mask = torch.empty((bsz, s, num_words(s)), dtype=torch.int64, device=boxes.device)
    if mask.numel() == 0:
        return mask
    launch_mask(_lib(), boxes, valid, iou_threshold, mask)
    mask_launches += 1
    return mask


def nms_sweep_cuda(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Launch the sweep kernel. mask from ``nms_mask_words_cuda``, valid
    (B, S) bool in sorted order -> keep (B, S) bool in sorted order."""
    global sweep_launches
    fn = "nms_sweep_cuda"
    if not mask.is_cuda:
        raise ValueError(f"{fn}: mask must be a CUDA tensor, got {mask.device}")
    if valid.dim() != 2:
        raise ValueError(f"{fn}: valid must be (B, S), got {tuple(valid.shape)}")
    bsz, s = valid.shape
    check_arg(fn, "mask", mask, torch.int64, (bsz, s, num_words(s)), mask.device)
    check_arg(fn, "valid", valid, torch.bool, (bsz, s), mask.device)
    keep = torch.empty((bsz, s), dtype=torch.bool, device=mask.device)
    if keep.numel() == 0:
        return keep
    launch_sweep(_lib(), mask, valid, keep)
    sweep_launches += 1
    return keep


def nms_keep_sorted_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Greedy keep in sorted order: boxes (B, S, 4) float32 and valid (B, S)
    bool, both sorted by score -> keep (B, S) bool. The two kernels, no host
    sync."""
    return nms_sweep_cuda(nms_mask_words_cuda(boxes, valid, iou_threshold), valid)
