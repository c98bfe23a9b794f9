"""Test-time image and box transforms on the host (numpy + PIL).

Counterpart of the deterministic part of ``sos_wsod_tpu/data/transforms.py``
(detectron2's ResizeShortestEdge at test time): the new size is
``int(scale * edge + 0.5)``, images resize with PIL bilinear, and boxes scale
by new/old per axis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


class ResizeTransform:
    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    @property
    def output_size(self) -> Tuple[int, int]:
        return self.new_h, self.new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (new_h, new_w, 3) uint8."""
        if img.shape[:2] != (self.h, self.w) or img.dtype != np.uint8:
            raise ValueError(f"expected a ({self.h}, {self.w}, 3) uint8 image, got "
                             f"{img.shape} {img.dtype}")
        return np.asarray(Image.fromarray(img).resize((self.new_w, self.new_h), Image.BILINEAR))

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """(N, 4) XYXY -> float32 in the resized image."""
        out = boxes.astype(np.float32)
        out[:, 0::2] *= self.new_w * 1.0 / self.w
        out[:, 1::2] *= self.new_h * 1.0 / self.h
        return out


def resize_shortest_edge(h: int, w: int, size: int, max_size: int) -> ResizeTransform:
    """Resize so the short edge is ``size``, unless the long edge would then
    exceed ``max_size``."""
    scale = size * 1.0 / min(h, w)
    newh, neww = (size, scale * w) if h < w else (scale * h, size)
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return ResizeTransform(h, w, int(newh + 0.5), int(neww + 0.5))


def clip_boxes(boxes: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Clip (N, 4) XYXY boxes to an image of size hw = (h, w)."""
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, hw[1])
    out[:, 1::2] = np.clip(out[:, 1::2], 0, hw[0])
    return out
