"""The dense CRF: mean-field refinement on the host (C++ through ctypes).

Counterpart of ``sos_wsod_tpu/ops/dense_crf.py``, the reference's production
CRF path (the pydensecrf wrapper seg_heads/crf.py that the WSJDS
segmentation branch calls). ``native/dense_crf.cpp`` is the port's own copy
of the JAX package's C++ source, byte for byte: Krähenbühl's mean-field
updates with a spatial Gaussian and a bilateral Potts kernel, the
high-dimensional filtering by a splat / blur / slice bilateral grid. It is
built at first use with g++ and the JAX binding's flags
(``kernels/build.py:build_host``), so the same source, compiler and flags
give the same bits as the JAX op.

``dense_crf`` takes numpy arrays and runs on the host, as the JAX op and the
reference do:
  - unary energies -log(clip(p, 1e-5, 1)) (pydensecrf's unary_from_softmax);
  - the spatial standard deviations of both kernels divided by the float
    scale ``size_std / max(H, W)``;
  - the guide image uint8 as it is, or float (BGR minus the pixel means)
    with the means added back and clipped to uint8; resized to the
    probabilities' size by nearest index maps where it differs;
  - the marginals returned as the inference leaves them.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..kernels.build import build_host

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_F32P = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_host("dense_crf")))
            lib.sos_dense_crf.restype = ctypes.c_int
            lib.sos_dense_crf.argtypes = [
                _F32P, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                *[ctypes.c_float] * 9, _F32P]
            lib.sos_grid_filter.restype = None
            lib.sos_grid_filter.argtypes = [_F32P, _F32P, _F32P,
                                            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            _LIB = lib
    return _LIB


def grid_filter(features: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Gaussian filtering of (n, c) ``values`` over (n, d) ``features``
    through the bilateral grid, sigma 1 in the feature space (divide the
    features by the wanted standard deviations)."""
    features = np.ascontiguousarray(features, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    n, d = features.shape
    out = np.empty((n, values.shape[1]), np.float32)
    _lib().sos_grid_filter(features.ctypes.data_as(_F32P), values.ctypes.data_as(_F32P),
                           out.ctypes.data_as(_F32P), n, d, values.shape[1])
    return out


def dense_crf(
    probs: np.ndarray,           # (C, H, W) class probabilities
    image: np.ndarray,           # (3, H', W') uint8, or float (BGR - pixel means)
    *,
    max_iter: int = 10,
    size_std: float = 500.0,
    pos_w: float = 3.0,
    pos_x_std: float = 3.0,
    pos_y_std: float = 3.0,
    bi_w: float = 10.0,
    bi_x_std: float = 80.0,
    bi_y_std: float = 80.0,
    bi_r_std: float = 13.0,
    bi_g_std: float = 13.0,
    bi_b_std: float = 13.0,
    pixel_means=(102.9801, 115.9465, 122.7717),
) -> np.ndarray:
    """The refined (C, H, W) f32 probabilities; the defaults are the
    reference's (seg_heads/crf.py)."""
    c, h, w = probs.shape
    if image.dtype == np.uint8:
        img = np.ascontiguousarray(np.moveaxis(image, 0, -1))
    else:
        im = np.moveaxis(np.asarray(image, np.float32), 0, -1)
        im = im + np.asarray(pixel_means, np.float32)
        img = np.clip(im, 0, 255).astype(np.uint8)
    if img.shape[:2] != (h, w):
        ys = np.clip((np.arange(h) * img.shape[0] / h), 0, img.shape[0] - 1).astype(int)
        xs = np.clip((np.arange(w) * img.shape[1] / w), 0, img.shape[1] - 1).astype(int)
        img = np.ascontiguousarray(img[ys][:, xs])

    unary = -np.log(np.clip(np.asarray(probs, np.float32), 1e-5, 1.0))
    unary = np.ascontiguousarray(np.moveaxis(unary, 0, -1).reshape(-1, c))
    scale = 1.0 * size_std / max(h, w)
    out = np.empty((h * w, c), np.float32)
    ret = _lib().sos_dense_crf(
        unary.ctypes.data_as(_F32P), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, int(max_iter),
        pos_w, pos_x_std / scale, pos_y_std / scale,
        bi_w, bi_x_std / scale, bi_y_std / scale,
        bi_r_std, bi_g_std, bi_b_std,
        out.ctypes.data_as(_F32P))
    if ret != 0:
        raise RuntimeError(f"sos_dense_crf failed with code {ret}")
    return np.moveaxis(out.reshape(h, w, c), -1, 0)
