"""Stage-1 training mappers: the multi-input one (one image -> 4
synchronized padded views) and the single-view one.

Counterpart of ``DatasetMapperMultiInput`` in
``sos_wsod_tpu/data/mapper_multi.py`` (reference
uwsod/detectron2/data/dataset_mapper.py:192-439):
  - one random crop shared by all views (when enabled);
  - scale 1: ResizeShortestEdge(a random choice of MIN_SIZE_TRAIN);
  - scale 2: the same with scale 1's short edge left out of the choice, and
    drawn again until its shape differs from scale 1's;
  - views 3 and 4 are views 1 and 2 flipped horizontally;
  - proposals transformed per view and clipped; a proposal is kept when it
    is unique and non-empty in all 4 views; they are padded to a fixed
    capacity with a validity mask;
  - each scale's images are padded to their own canvas, divisible by
    ``size_divisibility``; scale 2's canvas is derived from scale 1's
    through a ratio quantized to eighths.
``DatasetMapperSingle`` (the reference's stock DatasetMapper, for
GeneralizedRCNNWSL): one random crop (when enabled), one
ResizeShortestEdge(a random choice of MIN_SIZE_TRAIN), a random horizontal
flip; the proposals transformed, clipped, kept when unique and non-empty and
padded; the image padded to its canvas.
Random draws come from one ``np.random.RandomState`` per mapper in the JAX
package's order, so both packages map an image to the same arrays. ``plan``
splits a call into the draws and the mapping, so that threads can map images
while the draws stay in stream order.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..core.boxes import unique_boxes_keep_mask
from . import transforms as T


def _nonempty(boxes: np.ndarray) -> np.ndarray:
    return ((boxes[:, 2] - boxes[:, 0]) > 0) & ((boxes[:, 3] - boxes[:, 1]) > 0)


def read_image_bgr(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"))
    return arr[:, :, ::-1].copy()


def bucket_shape(h: int, w: int, divisibility: int):
    return -(-h // divisibility) * divisibility, -(-w // divisibility) * divisibility


def pad_image(img: np.ndarray, bh: int, bw: int) -> np.ndarray:
    out = np.zeros((bh, bw, img.shape[2]), dtype=img.dtype)
    out[:img.shape[0], :img.shape[1]] = img
    return out


def pick_capacity(n: int, buckets: Sequence[int], capacity: int) -> int:
    """The smallest configured proposal bucket that holds ``n`` proposals
    (TPU.PROPOSAL_BUCKETS), else ``capacity``."""
    caps = tuple(buckets) or (capacity,)
    for b in caps:
        if n <= b:
            return b
    return caps[-1]


class DatasetMapperMultiInput:
    def __init__(self, *, min_size_train: Sequence[int], max_size_train: int,
                 crop_enabled: bool = True, crop_type: str = "relative_range",
                 crop_size: Sequence[float] = (0.9, 0.9), proposal_topk: int = 4000,
                 proposal_capacity: int = 4096, proposal_buckets: Sequence[int] = (),
                 num_classes: int = 20, size_divisibility: int = 64, seed: int = 1234):
        self.min_size_train = list(min_size_train)
        self.max_size_train = max_size_train
        self.crop_enabled = crop_enabled
        self.crop_type = crop_type
        self.crop_size = list(crop_size)
        self.proposal_topk = proposal_topk
        self.capacity = proposal_capacity
        self.proposal_buckets = tuple(sorted(int(b) for b in proposal_buckets))
        self.num_classes = num_classes
        self.size_divisibility = size_divisibility
        self.rng = np.random.RandomState(seed)

    @classmethod
    def from_cfg(cls, cfg) -> "DatasetMapperMultiInput":
        return cls(min_size_train=cfg.INPUT.MIN_SIZE_TRAIN,
                   max_size_train=cfg.INPUT.MAX_SIZE_TRAIN,
                   crop_enabled=cfg.INPUT.CROP.ENABLED, crop_type=cfg.INPUT.CROP.TYPE,
                   crop_size=cfg.INPUT.CROP.SIZE,
                   proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN,
                   proposal_capacity=cfg.TPU.PROPOSAL_CAPACITY,
                   proposal_buckets=cfg.TPU.PROPOSAL_BUCKETS,
                   num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                   size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY, seed=max(cfg.SEED, 0))

    def _scale2(self, h, w, shape1):
        # the reference's scale-2 resize has no max size (dataset_mapper.py:
        # 310-317); a one-size list falls back to the full list and accepts
        # an equal shape after the bounded retries
        sizes = [s for s in self.min_size_train if s != min(shape1)] or list(self.min_size_train)
        for _ in range(100):
            t = T.resize_shortest_edge(h, w, sizes, 2 ** 31, self.rng)
            if t.output_size != tuple(shape1):
                return t
        return t

    def __call__(self, dataset_dict: Dict) -> Optional[Dict]:
        """A dataset dict (``image`` (H, W, 3) uint8 BGR or ``file_name``,
        ``proposal_boxes``, ``proposal_objectness_logits``, ``annotations``)
        -> the batch keys of ``MultiInputRCNN.loss`` plus ``image_id``, or
        None for an image without kept proposals or labels."""
        return self.plan(dataset_dict)()

    def plan(self, dataset_dict: Dict) -> Callable[[], Optional[Dict]]:
        """Draw the image's random transforms now and return the call that
        maps it with them, which draws nothing and may run on any thread.
        The image size comes from ``image``, else from ``height`` and
        ``width``, else from reading ``file_name``."""
        d = dict(dataset_dict)
        image = d.get("image")
        if image is None and "height" not in d:
            image = read_image_bgr(d["file_name"])
        hw = image.shape[:2] if image is not None else (d["height"], d["width"])
        crop = (T.random_crop(*hw, self.crop_type, self.crop_size, self.rng)
                if self.crop_enabled else T.NoOpTransform(*hw))
        ch, cw = crop.output_size
        t1 = T.resize_shortest_edge(ch, cw, self.min_size_train, self.max_size_train, self.rng)
        t2 = self._scale2(ch, cw, t1.output_size)
        return functools.partial(self._map, d, image, hw, crop, t1, t2)

    def _map(self, d, image, hw, crop, t1, t2) -> Optional[Dict]:
        if image is None:
            image = read_image_bgr(d["file_name"])
        if image.shape[:2] != tuple(hw):
            raise ValueError(f"image {d.get('image_id')} is {image.shape[:2]}, its dict says {hw}")
        image_c = crop.apply_image(image)
        img1 = t1.apply_image(image_c)
        shape1 = img1.shape[:2]
        img2 = t2.apply_image(image_c)
        shape2 = img2.shape[:2]
        f1, f2 = T.HFlipTransform(*shape1), T.HFlipTransform(*shape2)
        views = [T.TransformList([crop, t1]), T.TransformList([crop, t1, f1]),
                 T.TransformList([crop, t2]), T.TransformList([crop, t2, f2])]
        shapes = [shape1, shape1, shape2, shape2]

        raw_boxes = np.asarray(d["proposal_boxes"], np.float32)[:max(self.proposal_topk, 0) or None]
        raw_logits = np.asarray(d["proposal_objectness_logits"], np.float32)[:raw_boxes.shape[0]]
        boxes_v = [T.clip_boxes(tl.apply_box(raw_boxes), shp) for tl, shp in zip(views, shapes)]
        keep = np.logical_and.reduce([unique_boxes_keep_mask(b) & _nonempty(b) for b in boxes_v])
        n_kept = int(keep.sum())
        if n_kept == 0:
            return None
        cap = pick_capacity(n_kept, self.proposal_buckets, self.capacity)
        n = min(n_kept, cap)
        out_boxes = np.zeros((4, cap, 4), np.float32)
        for v in range(4):
            out_boxes[v, :n] = boxes_v[v][keep][:n]
        objectness = np.zeros((cap,), np.float32)
        objectness[:n] = raw_logits[keep][:n]

        gt_oh = _image_labels(d, self.num_classes)
        if gt_oh is None:
            return None

        bh1, bw1 = bucket_shape(shape1[0], shape1[1], self.size_divisibility)
        ratio = math.ceil(max(max(shape2[0] / bh1, shape2[1] / bw1), 1e-6) * 8) / 8
        bh2, bw2 = bucket_shape(math.ceil(bh1 * ratio), math.ceil(bw1 * ratio),
                                self.size_divisibility)
        imgs_s1 = np.stack([pad_image(img1, bh1, bw1),
                            pad_image(f1.apply_image(img1), bh1, bw1)]).astype(np.float32)
        imgs_s2 = np.stack([pad_image(img2, bh2, bw2),
                            pad_image(f2.apply_image(img2), bh2, bw2)]).astype(np.float32)
        return {
            "images_s1": imgs_s1,
            "images_s2": imgs_s2,
            "valid_hw_s1": np.array([shape1, shape1], np.int32),
            "valid_hw_s2": np.array([shape2, shape2], np.int32),
            "boxes": out_boxes,
            "objectness": objectness,
            "prop_valid": np.arange(cap) < n,
            "gt_classes_oh": gt_oh,
            "image_id": d.get("image_id"),
        }


def _image_labels(d: Dict, num_classes: int) -> Optional[np.ndarray]:
    """The one-hot image-level labels of a dataset dict's non-crowd
    annotations, or None when it has none."""
    classes = sorted({a["category_id"] for a in d.get("annotations", [])
                      if not a.get("iscrowd", 0)})
    if not classes:
        return None
    gt_oh = np.zeros((num_classes,), np.float32)
    gt_oh[classes] = 1.0
    return gt_oh


class DatasetMapperSingle:
    """Single-view training mapper of ``GeneralizedRCNNWSL`` (counterpart of
    the JAX package's ``DatasetMapperSingle``). Returns the batch keys of
    ``GeneralizedRCNNWSL.loss`` plus ``image_id``, or None for an image
    without kept proposals or labels."""

    def __init__(self, *, min_size_train: Sequence[int], max_size_train: int,
                 crop_enabled: bool = False, crop_type: str = "relative_range",
                 crop_size: Sequence[float] = (0.9, 0.9), random_flip: bool = True,
                 proposal_topk: int = 4000, proposal_capacity: int = 4096,
                 proposal_buckets: Sequence[int] = (), num_classes: int = 20,
                 size_divisibility: int = 64, seed: int = 1234):
        self.min_size_train = list(min_size_train)
        self.max_size_train = max_size_train
        self.crop_enabled = crop_enabled
        self.crop_type = crop_type
        self.crop_size = list(crop_size)
        self.random_flip = random_flip
        self.proposal_topk = proposal_topk
        self.capacity = proposal_capacity
        self.proposal_buckets = tuple(sorted(int(b) for b in proposal_buckets))
        self.num_classes = num_classes
        self.size_divisibility = size_divisibility
        self.rng = np.random.RandomState(seed)

    @classmethod
    def from_cfg(cls, cfg) -> "DatasetMapperSingle":
        return cls(min_size_train=cfg.INPUT.MIN_SIZE_TRAIN,
                   max_size_train=cfg.INPUT.MAX_SIZE_TRAIN,
                   crop_enabled=cfg.INPUT.CROP.ENABLED, crop_type=cfg.INPUT.CROP.TYPE,
                   crop_size=cfg.INPUT.CROP.SIZE, random_flip=cfg.INPUT.RANDOM_FLIP != "none",
                   proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN,
                   proposal_capacity=cfg.TPU.PROPOSAL_CAPACITY,
                   proposal_buckets=cfg.TPU.PROPOSAL_BUCKETS,
                   num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                   size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY, seed=max(cfg.SEED, 0))

    def __call__(self, dataset_dict: Dict) -> Optional[Dict]:
        return self.plan(dataset_dict)()

    def plan(self, dataset_dict: Dict) -> Callable[[], Optional[Dict]]:
        """Draw the crop, the short edge and the flip now (in that order)
        and return the call that maps the image with them."""
        d = dict(dataset_dict)
        image = d.get("image")
        if image is None and "height" not in d:
            image = read_image_bgr(d["file_name"])
        hw = image.shape[:2] if image is not None else (d["height"], d["width"])
        tl = [T.random_crop(*hw, self.crop_type, self.crop_size, self.rng)
              if self.crop_enabled else T.NoOpTransform(*hw)]
        tl.append(T.resize_shortest_edge(*tl[-1].output_size, self.min_size_train,
                                         self.max_size_train, self.rng))
        if self.random_flip and self.rng.rand() < 0.5:
            tl.append(T.HFlipTransform(*tl[-1].output_size))
        return functools.partial(self._map, d, image, hw, T.TransformList(tl))

    def _map(self, d, image, hw, tfm) -> Optional[Dict]:
        if image is None:
            image = read_image_bgr(d["file_name"])
        if image.shape[:2] != tuple(hw):
            raise ValueError(f"image {d.get('image_id')} is {image.shape[:2]}, its dict says {hw}")
        img = tfm.apply_image(image).astype(np.float32)
        ih, iw = tfm.output_size
        raw_boxes = np.asarray(d["proposal_boxes"], np.float32)[:max(self.proposal_topk, 0) or None]
        raw_logits = np.asarray(d["proposal_objectness_logits"], np.float32)[:raw_boxes.shape[0]]
        b = T.clip_boxes(tfm.apply_box(raw_boxes), (ih, iw))
        keep = unique_boxes_keep_mask(b) & _nonempty(b)
        n_kept = int(keep.sum())
        if n_kept == 0:
            return None
        cap = pick_capacity(n_kept, self.proposal_buckets, self.capacity)
        n = min(n_kept, cap)
        boxes = np.zeros((cap, 4), np.float32)
        boxes[:n] = b[keep][:n]
        objectness = np.zeros((cap,), np.float32)
        objectness[:n] = raw_logits[keep][:n]
        gt_oh = _image_labels(d, self.num_classes)
        if gt_oh is None:
            return None
        bh, bw = bucket_shape(ih, iw, self.size_divisibility)
        return {
            "image": pad_image(img, bh, bw),
            "valid_hw": np.array([ih, iw], np.int32),
            "boxes": boxes,
            "objectness": objectness,
            "prop_valid": np.arange(cap) < n,
            "gt_classes_oh": gt_oh,
            "image_id": d.get("image_id"),
        }
