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

import torch

from .build import build
from .roi_pool import check_arg

mask_launches = 0
sweep_launches = 0

TILE = 64   # boxes per mask word (kTile in csrc/nms.cu)


def num_words(s: int) -> int:
    return -(-s // TILE)


def traffic_bytes(batch: int, s: int) -> int:
    """Bytes the two kernels must move for ``batch`` problems of ``s``
    boxes: the boxes and valid flags read, the mask words on and above the
    diagonal written once and read once by the sweep, the keep flags
    written."""
    w = num_words(s)
    words = TILE * w * (w + 1) // 2
    return batch * (16 * s + s + 2 * 8 * words + s)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("nms")))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_nms_mask.argtypes = [vp, ci, ci, ctypes.c_float, vp, vp]
    lib.sos_nms_mask.restype = ci
    lib.sos_nms_sweep.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.sos_nms_sweep.restype = ci
    return lib


def nms_mask_words_cuda(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Launch the bitmask kernel. boxes (B, S, 4) float32 on a CUDA device,
    score-sorted -> mask (B, S, ceil(S / 64)) int64 words (bit t of word w
    of row i: box i suppresses box 64 w + t), written on and above the
    diagonal only."""
    global mask_launches
    fn = "nms_mask_words_cuda"
    if not boxes.is_cuda:
        raise ValueError(f"{fn}: boxes must be a CUDA tensor, got {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{fn}: boxes must be (B, S, 4), got {tuple(boxes.shape)}")
    bsz, s, _ = boxes.shape
    check_arg(fn, "boxes", boxes, torch.float32, (bsz, s, 4), boxes.device)
    if boxes.data_ptr() % 16:
        raise ValueError(f"{fn}: boxes must start at a 16-byte aligned address")
    if bsz > 65535 or num_words(s) > 65535:
        raise ValueError(f"{fn}: batch {bsz} or {s} boxes exceed the kernel's grid")
    mask = torch.empty((bsz, s, num_words(s)), dtype=torch.int64, device=boxes.device)
    if mask.numel() == 0:
        return mask
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _lib().sos_nms_mask(boxes.data_ptr(), bsz, s, float(iou_threshold),
                                  mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
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
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = _lib().sos_nms_sweep(mask.data_ptr(), valid.data_ptr(), bsz, s, keep.data_ptr(),
                                   stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
    sweep_launches += 1
    return keep


def nms_keep_sorted_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Greedy keep in sorted order: boxes (B, S, 4) float32 and valid (B, S)
    bool, both sorted by score -> keep (B, S) bool. The two kernels, no host
    sync."""
    return nms_sweep_cuda(nms_mask_words_cuda(boxes, iou_threshold), valid)
