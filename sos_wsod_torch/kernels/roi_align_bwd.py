"""ctypes binding of the CUDA multi-level ROIAlign backward
(``csrc/roi_align_bwd.cu``).

The wrapper validates its inputs, allocates the zeroed f32 sums with
``torch.zeros`` (and, for bfloat16, the gradient with ``torch.empty``),
launches on PyTorch's current stream, and returns each level's (H_l, W_l,
C) gradient as a view of one buffer that holds the levels after one another.
It raises on anything the kernel does not take and when the launch reports
an error; it never falls back to the plain version. ``launches`` counts the
calls that launched the kernel in this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from .build import build
from .roi_align import DTYPES, MAX_LEVELS
from .roi_pool import check_arg

launches = 0

OPS_PER_SAMPLE = 8   # f32 operations a sample-channel: 4 products, 4 adds
MAX_CAP = 1536       # the sample tables, 2 x cap entries of 16 bytes, in 48 KB


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
                                      ci, vp, vp, vp, vp]
    lib.sos_roi_align_bwd.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build("roi_align_bwd"))


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
    cap = sampling_ratio if sampling_ratio > 0 else sample_cap
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"{fn}: sample cap {cap} outside [1, {MAX_CAP}]")
    for h, w in shapes:
        if h < 1 or w < 1:
            raise ValueError(f"{fn}: level of shape {(h, w)}")
    sizes = [h * w * c for h, w in shapes]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    out = acc if grad.dtype == torch.float32 else torch.empty(sum(sizes), dtype=grad.dtype,
                                                             device=dev)
    n = len(shapes)
    hs = (ctypes.c_int * n)(*[h for h, _ in shapes])
    ws = (ctypes.c_int * n)(*[w for _, w in shapes])
    scales = (ctypes.c_float * n)(*[float(s) for s in spatial_scales])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().sos_roi_align_bwd(
            DTYPES[grad.dtype], n, hs, ws, scales, c, boxes.data_ptr(), level.data_ptr(),
            valid.data_ptr(), p, ph, pw, sampling_ratio, cap, int(aligned), grad.data_ptr(),
            acc.data_ptr(), None if out is acc else out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {err}")
    launches += 1
    return [g.view(h, w, c) for g, (h, w) in zip(out.split(sizes), shapes)]
