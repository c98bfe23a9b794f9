"""The plain reference's own mapping of raw images to model inputs.

The same semantics as the system's data path (detectron2's transforms):
  - training: an infinite stream of indices, a seeded permutation repeated;
    per image one crop "relative_range" (a fraction in [size, 1] per axis,
    a random corner), scale 1 ResizeShortestEdge(a random choice of the size
    list, max size), scale 2 the same without scale 1's short edge and no
    max size, drawn until its shape differs; views 2 and 4 are views 1 and 3
    flipped (x' = w - x); proposals transformed, clipped, kept when unique
    and non-empty in every view, padded to the capacity; each scale padded
    to a canvas divisible by the divisibility (scale 2's from scale 1's
    through a ratio in eighths);
  - test: ResizeShortestEdge(test size, max size), proposals transformed,
    clipped, unique and non-empty, the top k padded.
Images resize with PIL's bilinear filter, sizes round as int(x + 0.5). All
random draws come from one numpy RandomState a stream, in the order above,
so that the reference sees the images the system was fed; it imports
nothing of the system.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
from PIL import Image


def resize_shape(h: int, w: int, size: int, max_size: float) -> Tuple[int, int]:
    scale = size * 1.0 / min(h, w)
    newh, neww = (size, scale * w) if h < w else (scale * h, size)
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize((hw[1], hw[0]), Image.BILINEAR))


def scale_boxes(boxes: np.ndarray, src: Tuple[int, int], dst: Tuple[int, int]) -> np.ndarray:
    out = boxes.astype(np.float32)
    out[:, 0::2] *= dst[1] * 1.0 / src[1]
    out[:, 1::2] *= dst[0] * 1.0 / src[0]
    return out


def flip_boxes(boxes: np.ndarray, w: int) -> np.ndarray:
    out = boxes.astype(np.float32)
    out[:, 0] = w - boxes[:, 2]
    out[:, 2] = w - boxes[:, 0]
    return out


def clip(boxes: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, hw[1])
    out[:, 1::2] = np.clip(out[:, 1::2], 0, hw[0])
    return out


def unique_nonempty(boxes: np.ndarray) -> np.ndarray:
    """First occurrence of each box by the hash round(box) . [1, 1e3, 1e6,
    1e9], and width and height above 0."""
    hashes = np.round(np.asarray(boxes, np.float64)).dot(
        np.array([1.0, 1e3, 1e6, 1e9])).astype(np.int64)
    _, index = np.unique(hashes, return_index=True)
    keep = np.zeros(boxes.shape[0], bool)
    keep[np.sort(index)] = True
    return keep & ((boxes[:, 2] - boxes[:, 0]) > 0) & ((boxes[:, 3] - boxes[:, 1]) > 0)


def canvas(h: int, w: int, div: int) -> Tuple[int, int]:
    return -(-h // div) * div, -(-w // div) * div


def pad(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    out = np.zeros((hw[0], hw[1], img.shape[2]), img.dtype)
    out[:img.shape[0], :img.shape[1]] = img
    return out


def index_stream(n: int, seed: int) -> Iterator[int]:
    rng = np.random.RandomState(seed)
    while True:
        yield from rng.permutation(n).tolist()


class TrainViews:
    """The 4-view training samples of a stream of dataset dicts, in order:
    ``next(views)`` maps the next image of the seeded index stream."""

    def __init__(self, dicts: List[dict], cfg: Dict, seed: int):
        self.dicts = dicts
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.stream = index_stream(len(dicts), seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            out = self._map(self.dicts[next(self.stream)])
            if out is not None:
                return out

    def _draw(self, h: int, w: int):
        c = self.cfg
        cs = np.asarray(c["crop_size"], dtype=np.float32)
        ch_f, cw_f = cs + self.rng.rand(2).astype(np.float32) * (1 - cs)
        ch, cw = int(h * ch_f + 0.5), int(w * cw_f + 0.5)
        y0 = self.rng.randint(h - ch + 1)
        x0 = self.rng.randint(w - cw + 1)
        sizes = list(c["min_size_train"])
        shape1 = resize_shape(ch, cw, int(self.rng.choice(sizes)), c["max_size_train"])
        sizes2 = [s for s in sizes if s != min(shape1)] or sizes
        for _ in range(100):
            shape2 = resize_shape(ch, cw, int(self.rng.choice(sizes2)), 2 ** 31)
            if shape2 != shape1:
                break
        return (y0, x0, ch, cw), shape1, shape2

    def _map(self, d: dict):
        c = self.cfg
        image = d["image"]
        h, w = image.shape[:2]
        (y0, x0, ch, cw), shape1, shape2 = self._draw(h, w)
        crop = image[y0:y0 + ch, x0:x0 + cw]
        img1, img2 = resize_image(crop, shape1), resize_image(crop, shape2)
        raw = np.asarray(d["proposal_boxes"], np.float32)[:c["proposal_topk"]]
        logits = np.asarray(d["proposal_objectness_logits"], np.float32)[:raw.shape[0]]
        cropped = raw.astype(np.float32)
        cropped[:, 0::2] -= x0
        cropped[:, 1::2] -= y0
        views = []
        for shape in (shape1, shape2):
            b = scale_boxes(cropped, (ch, cw), shape)
            views += [clip(b, shape), clip(flip_boxes(b, shape[1]), shape)]
        keep = np.logical_and.reduce([unique_nonempty(b) for b in views])
        n = min(int(keep.sum()), c["capacity"])
        classes = sorted({a["category_id"] for a in d["annotations"]})
        if n == 0 or not classes:
            return None
        cap = c["capacity"]
        boxes = np.zeros((4, cap, 4), np.float32)
        for v in range(4):
            boxes[v, :n] = views[v][keep][:n]
        objectness = np.zeros(cap, np.float32)
        objectness[:n] = logits[keep][:n]
        labels = np.zeros(c["num_classes"], np.float32)
        labels[classes] = 1.0
        div = c["divisibility"]
        bh1, bw1 = canvas(*shape1, div)
        ratio = math.ceil(max(max(shape2[0] / bh1, shape2[1] / bw1), 1e-6) * 8) / 8
        bh2, bw2 = canvas(math.ceil(bh1 * ratio), math.ceil(bw1 * ratio), div)
        flip = lambda a: np.ascontiguousarray(a[:, ::-1])  # noqa: E731
        return {
            "images_s1": np.stack([pad(img1, (bh1, bw1)), pad(flip(img1), (bh1, bw1))]
                                  ).astype(np.float32),
            "images_s2": np.stack([pad(img2, (bh2, bw2)), pad(flip(img2), (bh2, bw2))]
                                  ).astype(np.float32),
            "valid_hw_s1": np.array([shape1, shape1], np.int32),
            "valid_hw_s2": np.array([shape2, shape2], np.int32),
            "boxes": boxes,
            "objectness": objectness,
            "prop_valid": np.arange(cap) < n,
            "gt_classes_oh": labels,
        }


def test_sample(d: dict, cfg: Dict) -> Dict[str, np.ndarray]:
    """One image resized to the test size, its proposals mapped and padded."""
    image = d["image"]
    h, w = image.shape[:2]
    shape = resize_shape(h, w, cfg["min_size_test"], cfg["max_size_test"])
    img = resize_image(image, shape)
    cap = cfg["capacity"]
    b = clip(scale_boxes(np.asarray(d["proposal_boxes"], np.float32), (h, w), shape), shape)
    logits = np.asarray(d["proposal_objectness_logits"], np.float32)[:b.shape[0]]
    keep = unique_nonempty(b)
    b, logits = b[keep][:cfg["proposal_topk_test"]], logits[keep][:cfg["proposal_topk_test"]]
    n = min(b.shape[0], cap)
    boxes = np.zeros((cap, 4), np.float32)
    objectness = np.zeros(cap, np.float32)
    boxes[:n], objectness[:n] = b[:n], logits[:n]
    return {
        "image": pad(img.astype(np.float32), canvas(*shape, cfg["divisibility"])),
        "valid_hw": np.array(shape, np.int32),
        "boxes": boxes,
        "objectness": objectness,
        "prop_valid": np.arange(cap) < n,
        "image_hw": np.array(shape, np.float32),
        "orig_hw": np.array([h, w], np.float32),
    }

