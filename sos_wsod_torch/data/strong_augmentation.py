"""Photometric "strong" augmentations (SimCLR-style) in numpy and PIL.

Counterpart of ``sos_wsod_tpu/data/strong_augmentation.py`` (ubteacher's
build_strong_augmentation, unbias/ubteacher/data/detection_utils.py:9-47),
the same draws from one ``np.random.RandomState`` in the same order, so both
packages give the same arrays from one seed: ColorJitter(0.4, 0.4, 0.4, 0.1)
with p 0.8, RandomGrayscale 0.2, GaussianBlur with sigma U[0.1, 2] and p 0.5,
then three RandomErasing passes (p 0.7, 0.5, 0.3) filled with random values.
torchvision is not installed, so the transforms are written out with its
sampling rules (factor ranges, application order, the erasing's rejection
sampling of scale and ratio). All are photometric: the strong view keeps
the weak view's geometry, and so its boxes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


def _adjust_brightness(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Brightness(img).enhance(factor)


def _adjust_contrast(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Contrast(img).enhance(factor)


def _adjust_saturation(img: Image.Image, factor: float) -> Image.Image:
    return ImageEnhance.Color(img).enhance(factor)


def _adjust_hue(img: Image.Image, factor: float) -> Image.Image:
    """factor in [-0.5, 0.5]; shifts the hue channel like torchvision."""
    if factor == 0:
        return img
    h, s, v = img.convert("HSV").split()
    h_np = np.asarray(h, dtype=np.uint8)
    h_np = (h_np.astype(np.int16) + int(factor * 255)) % 256
    h = Image.fromarray(h_np.astype(np.uint8), "L")
    return Image.merge("HSV", (h, s, v)).convert("RGB")


def color_jitter(
    img: Image.Image,
    rng: np.random.RandomState,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.4,
    hue: float = 0.1,
) -> Image.Image:
    """torchvision ColorJitter: uniform factors in [1-x, 1+x] (hue in [-h, h]),
    applied in a random order."""
    ops = []
    b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
    ops.append(lambda im: _adjust_brightness(im, b))
    c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
    ops.append(lambda im: _adjust_contrast(im, c))
    s = rng.uniform(max(0, 1 - saturation), 1 + saturation)
    ops.append(lambda im: _adjust_saturation(im, s))
    h = rng.uniform(-hue, hue)
    ops.append(lambda im: _adjust_hue(im, h))
    for i in rng.permutation(4):
        img = ops[i](img)
    return img


def random_erasing(
    arr: np.ndarray,
    rng: np.random.RandomState,
    p: float,
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
) -> np.ndarray:
    """torchvision RandomErasing(value='random'): rejection-sample an erase
    rect (<=10 attempts) with area in scale*img_area and aspect in ratio;
    fill with N(0,1) noise in the normalized [0,1] domain like ToTensor."""
    if rng.rand() >= p:
        return arr
    h, w = arr.shape[:2]
    area = h * w
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        erase_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        eh = int(round(np.sqrt(erase_area * aspect)))
        ew = int(round(np.sqrt(erase_area / aspect)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            y = rng.randint(0, h - eh + 1)
            x = rng.randint(0, w - ew + 1)
            noise = rng.normal(size=(eh, ew, arr.shape[2])).astype(np.float32)
            arr = arr.copy()
            # torchvision RandomErasing(value='random') fills UNclipped N(0,1)
            # noise in the normalized domain; keep the float range here too.
            arr[y : y + eh, x : x + ew] = noise * 255.0
            return arr
    return arr


def build_strong_augmentation(seed: Optional[int] = None):
    """Returns fn(np.uint8 HWC RGB) -> np.float32 HWC RGB with the reference's
    strong-augmentation pipeline."""
    rng = np.random.RandomState(seed)

    def apply(arr: np.ndarray) -> np.ndarray:
        img = Image.fromarray(arr.astype(np.uint8))
        if rng.rand() < 0.8:
            img = color_jitter(img, rng)
        if rng.rand() < 0.2:
            img = img.convert("L").convert("RGB")
        if rng.rand() < 0.5:
            sigma = rng.uniform(0.1, 2.0)
            img = img.filter(ImageFilter.GaussianBlur(radius=sigma))
        out = np.asarray(img, dtype=np.float32)
        out = random_erasing(out, rng, 0.7, (0.05, 0.2), (0.3, 3.3))
        out = random_erasing(out, rng, 0.5, (0.02, 0.2), (0.1, 6.0))
        out = random_erasing(out, rng, 0.3, (0.02, 0.2), (0.05, 8.0))
        return out

    return apply
