"""Anchor generation (static per feature-map shape).

Counterpart of ``sos_wsod_tpu/models/anchors.py`` (detectron2
DefaultAnchorGenerator): cell anchors from (size, aspect_ratio) pairs
centered at the origin, shifted over the (offset + index) * stride grid,
ordered (H, W, A) with A fastest. Computed with numpy on the host, in f32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """(len(sizes) * len(aspect_ratios), 4) XYXY anchors centered at (0, 0);
    for size in sizes: for ratio in ratios."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ratio in aspect_ratios:
            w = np.sqrt(area / ratio)
            h = ratio * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


def grid_anchors(feat_hw: Tuple[int, int], stride: int, base: np.ndarray,
                 offset: float = 0.0) -> np.ndarray:
    """(H * W * A, 4) anchors for one level; row-major over (y, x), A fastest."""
    h, w = feat_hw
    xs = (np.arange(w, dtype=np.float32) + offset) * stride
    ys = (np.arange(h, dtype=np.float32) + offset) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]
    return anchors.reshape(-1, 4)


class AnchorGenerator:
    def __init__(self, sizes: Sequence[Sequence[float]],
                 aspect_ratios: Sequence[Sequence[float]], strides: Sequence[int],
                 offset: float = 0.0):
        n = len(strides)
        if len(sizes) == 1:
            sizes = list(sizes) * n
        if len(aspect_ratios) == 1:
            aspect_ratios = list(aspect_ratios) * n
        if len(sizes) != n or len(aspect_ratios) != n:
            raise ValueError(f"{len(sizes)} sizes and {len(aspect_ratios)} aspect ratios "
                             f"for {n} levels")
        self.strides = list(strides)
        self.cell = [cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]
        self.offset = offset

    @property
    def num_anchors_per_location(self) -> List[int]:
        return [c.shape[0] for c in self.cell]

    def __call__(self, feat_hws: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Per-level (H_l * W_l * A_l, 4) anchors for the given feature shapes."""
        if len(feat_hws) != len(self.strides):
            raise ValueError(f"{len(feat_hws)} feature shapes for {len(self.strides)} levels")
        return [grid_anchors(hw, s, c, self.offset)
                for hw, s, c in zip(feat_hws, self.strides, self.cell)]

    @classmethod
    def from_cfg(cls, cfg, strides: Sequence[int]) -> "AnchorGenerator":
        return cls(sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
                   aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
                   strides=strides, offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET)
