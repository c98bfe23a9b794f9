"""The least time of an operation on the card: the larger of its bytes (each
input read once, each output written once) over the HBM rate and its f32
operations over the f32 rate. Counted from the shapes at the operation's
call, whatever the kernel that runs it reads again."""
from __future__ import annotations

from . import peaks


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_FLOPS)


def roi_pool_fwd(h: int, w: int, c: int, p: int, res: int, itemsize: int, with_pos: bool,
                 cells: int) -> float:
    """ROIPool forward: the (h, w, c) map, the (p, 4) f32 boxes, p valid
    flags and p f32 scales read; out (p, res, res, c), and the int32 argmax
    when training, written. Operations: one compare per window cell and
    channel, one multiply per output."""
    nbytes = h * w * c * itemsize + p * 16 + p + p * 4 + \
        p * res * res * c * (itemsize + (4 if with_pos else 0))
    return bound_s(nbytes, cells * c + p * res * res * c)


def roi_pool_bwd(h: int, w: int, c: int, p: int, res: int, itemsize: int) -> float:
    """ROIPool backward: the cotangent and the int32 argmax (p, res, res, c)
    and the p f32 scales read; the map's gradient (h, w, c) written in the
    map's type. Operations: a multiply and an add per cotangent entry."""
    nbytes = p * res * res * c * (itemsize + 4) + p * 4 + h * w * c * itemsize
    return bound_s(nbytes, 2 * p * res * res * c)


def roi_align_fwd(level_hwc, p_valid: int, p_slots: int, res: int, itemsize: int,
                  samples: int) -> float:
    """Multi-level ROIAlign forward: every level's map read once, the
    (p, 4) boxes and valid flags read; out (p, c, res, res) written.
    Operations: 9 f32 operations for each channel of each bilinear sample
    (4 weights, 4 products and the sum), ``samples`` the sample points of
    the valid ROIs' bins."""
    c = level_hwc[0][2]
    nbytes = sum(h * w * cc * itemsize for h, w, cc in level_hwc) + p_slots * 17 + \
        p_slots * res * res * c * itemsize
    return bound_s(nbytes, 9 * samples * c)
