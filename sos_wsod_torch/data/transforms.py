"""Image and box transforms on the host (numpy + PIL).

Counterpart of ``sos_wsod_tpu/data/transforms.py`` (detectron2/fvcore
semantics):
  - ResizeShortestEdge: the new size is ``int(scale * edge + 0.5)``, images
    resize with PIL bilinear, boxes scale by new/old per axis; at training
    the short edge is a random choice from a size list;
  - HFlip: x' = width - x (no -1, the d2 convention);
  - crop "relative_range": a fraction ~ U[size, 1] per axis,
    int(d * frac + 0.5), a random top-left; boxes translate by (-x0, -y0).
Each transform's ``inverse_box`` maps boxes back to its input, in float64
(the no-op returns them as they are); test-time augmentation maps each
view's detections back with it.
All randomness comes from an explicit ``np.random.RandomState``, drawn in
the JAX package's order, so both packages map an image identically.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image


class NoOpTransform:
    def __init__(self, h: int, w: int):
        self._hw = (h, w)

    @property
    def output_size(self) -> Tuple[int, int]:
        return self._hw

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return img

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        return boxes

    def inverse_box(self, boxes: np.ndarray) -> np.ndarray:
        return boxes


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

    def inverse_box(self, boxes: np.ndarray) -> np.ndarray:
        out = np.asarray(boxes, np.float64).copy()
        out[:, 0::2] *= self.w * 1.0 / self.new_w
        out[:, 1::2] *= self.h * 1.0 / self.new_h
        return out


def resize_shortest_edge(h: int, w: int, short_edge_length: Union[int, Sequence[int]],
                         max_size: int, rng: Optional[np.random.RandomState] = None):
    """Resize so the short edge is ``short_edge_length`` (a random choice
    from the list when ``rng`` is given, else its first entry), unless the
    long edge would then exceed ``max_size``. A size of 0 is a no-op."""
    sizes = [short_edge_length] if isinstance(short_edge_length, int) else list(short_edge_length)
    size = int(rng.choice(sizes)) if rng is not None else int(sizes[0])
    if size == 0:
        return NoOpTransform(h, w)
    scale = size * 1.0 / min(h, w)
    newh, neww = (size, scale * w) if h < w else (scale * h, size)
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return ResizeTransform(h, w, int(newh + 0.5), int(neww + 0.5))


class HFlipTransform:
    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    @property
    def output_size(self) -> Tuple[int, int]:
        return self.h, self.w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(img[:, ::-1])

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        out = boxes.astype(np.float32)
        out[:, 0] = self.w - boxes[:, 2]
        out[:, 2] = self.w - boxes[:, 0]
        return out

    def inverse_box(self, boxes: np.ndarray) -> np.ndarray:
        out = np.asarray(boxes, np.float64).copy()
        out[:, 0] = self.w - boxes[:, 2]
        out[:, 2] = self.w - boxes[:, 0]
        return out


class CropTransform:
    def __init__(self, x0: int, y0: int, ch: int, cw: int):
        self.x0, self.y0, self.ch, self.cw = x0, y0, ch, cw

    @property
    def output_size(self) -> Tuple[int, int]:
        return self.ch, self.cw

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return img[self.y0:self.y0 + self.ch, self.x0:self.x0 + self.cw]

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        out = boxes.astype(np.float32)
        out[:, 0::2] -= self.x0
        out[:, 1::2] -= self.y0
        return out

    def inverse_box(self, boxes: np.ndarray) -> np.ndarray:
        out = np.asarray(boxes, np.float64).copy()
        out[:, 0::2] += self.x0
        out[:, 1::2] += self.y0
        return out


class TransformList:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    @property
    def output_size(self) -> Tuple[int, int]:
        return self.transforms[-1].output_size

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            boxes = t.apply_box(boxes)
        return boxes

    def inverse_box(self, boxes: np.ndarray) -> np.ndarray:
        for t in reversed(self.transforms):
            boxes = t.inverse_box(boxes)
        return boxes


def random_crop(h: int, w: int, crop_type: str, crop_size,
                rng: np.random.RandomState) -> CropTransform:
    """detectron2's RandomCrop: the crop size by ``crop_type``, then a
    uniformly random top-left corner."""
    if crop_type == "relative":
        ch, cw = int(h * crop_size[0] + 0.5), int(w * crop_size[1] + 0.5)
    elif crop_type == "relative_range":
        cs = np.asarray(crop_size, dtype=np.float32)
        ch_f, cw_f = cs + rng.rand(2).astype(np.float32) * (1 - cs)
        ch, cw = int(h * ch_f + 0.5), int(w * cw_f + 0.5)
    elif crop_type == "absolute":
        ch, cw = min(crop_size[0], h), min(crop_size[1], w)
    elif crop_type == "absolute_range":
        ch = rng.randint(min(h, crop_size[0]), min(h, crop_size[1]) + 1)
        cw = rng.randint(min(w, crop_size[0]), min(w, crop_size[1]) + 1)
    else:
        raise ValueError(f"unknown crop type {crop_type!r}")
    assert ch <= h and cw <= w
    y0 = rng.randint(h - ch + 1)
    x0 = rng.randint(w - cw + 1)
    return CropTransform(x0, y0, ch, cw)


def clip_boxes(boxes: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Clip (N, 4) XYXY boxes to an image of size hw = (h, w) (the JAX
    package's ``clip_boxes_np``)."""
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, hw[1])
    out[:, 1::2] = np.clip(out[:, 1::2], 0, hw[0])
    return out
