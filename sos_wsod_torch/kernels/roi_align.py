"""ctypes binding of the CUDA multi-level ROIAlign forward
(``csrc/roi_align_fwd.cu``).

The wrapper validates its inputs, allocates the output with ``torch.empty``
and launches on PyTorch's current stream. It raises on anything the kernel
does not take and when the launch reports an error; it never falls back to
the plain version. ``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .build import build
from .roi_pool import check_arg

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 8   # kMaxLevels in csrc/roi_align_fwd.cu


def traffic_bytes(features: Sequence[torch.Tensor], p: int, output_size=(7, 7)) -> int:
    """Bytes the function must move: every level's map read once, the
    output written once, the boxes, levels and valid flags read once."""
    isz = features[0].element_size()
    c = features[0].shape[-1]
    maps = sum(f.shape[0] * f.shape[1] for f in features) * c * isz
    return maps + p * output_size[0] * output_size[1] * c * isz + p * (16 + 4 + 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("roi_align_fwd")))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sos_roi_align_fwd.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, ci, ci,
                                      ci, ci, ci, vp, vp]
    lib.sos_roi_align_fwd.restype = ci
    return lib


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
    vec = 16 // f0.element_size()
    wide = int(c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (*features, out)))
    n = len(features)
    feats = (ctypes.c_int64 * n)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * n)(*[f.shape[0] for f in features])
    ws = (ctypes.c_int * n)(*[f.shape[1] for f in features])
    scales = (ctypes.c_float * n)(*[float(s) for s in spatial_scales])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sos_roi_align_fwd(
            DTYPES[f0.dtype], n, feats, hs, ws, scales, c, wide, boxes.data_ptr(),
            level.data_ptr(), valid.data_ptr(), p, ph, pw, sampling_ratio, cap, int(aligned),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
