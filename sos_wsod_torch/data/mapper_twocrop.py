"""Two-crop (strong, weak) mapper and the semi-supervised loader of stages 2-3.

Counterpart of ``sos_wsod_tpu/data/mapper_twocrop.py`` (ubteacher's
DatasetMapperTwoCropSeparate, divide_label_unlabel and its two-crop loader):
  - ``divide_label_unlabel``: the labeled indices of the dataseed JSON
    {percent: {seed: [index, ...]}}, the rest unlabeled;
  - ``DatasetMapperTwoCropSeparate``: one image -> (strong, weak) samples
    that share their geometry (optional crop, ResizeShortestEdge from
    MIN_SIZE_TRAIN, a random horizontal flip) and their gt, padded to
    TPU.PGT_CAPACITY slots with a validity mask, plus a multi-label one-hot;
    the strong view adds ``strong_augmentation``'s photometric changes;
  - ``build_semisup_two_crop_loader``: batches of {label_q, label_k,
    unlabel_q, unlabel_k} (q strong, k weak), each stream's q and k padded
    to one canvas.
Random draws come from one ``np.random.RandomState`` (and the strong
augmentation's own) in the JAX package's order, so both packages map an
image to the same arrays.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import transforms as T
from .build import get_detection_dataset_dicts, rank_and_world, training_index_stream
from .mapper_multi import bucket_shape, pad_image, read_image_bgr
from .strong_augmentation import build_strong_augmentation


def divide_label_unlabel(dataset_dicts: List[dict], sup_percent: float, random_data_seed: int,
                         random_data_seed_path: str) -> Tuple[List[dict], List[dict]]:
    """(labeled, unlabeled) dicts by the dataseed file; raises unless it
    lists int(sup_percent / 100 x the dataset's size) indices."""
    num_all = len(dataset_dicts)
    num_label = int(sup_percent / 100.0 * num_all)
    with open(random_data_seed_path) as f:
        seeds = json.load(f)
    labeled = seeds[str(sup_percent)][str(random_data_seed)]
    if len(labeled) != num_label:
        raise ValueError(f"{random_data_seed_path}: {len(labeled)} labeled indices for "
                         f"{sup_percent}% of {num_all} images (expected {num_label})")
    labeled = set(int(i) for i in labeled)
    label_dicts = [d for i, d in enumerate(dataset_dicts) if i in labeled]
    unlabel_dicts = [d for i, d in enumerate(dataset_dicts) if i not in labeled]
    return label_dicts, unlabel_dicts


class DatasetMapperTwoCropSeparate:
    """One image -> (strong sample, weak sample), padded numpy dicts with
    image, image_hw, gt_boxes, gt_classes, gt_valid, multi_label_oh,
    image_id and orig_hw."""

    def __init__(self, *, min_size_train: Sequence[int], max_size_train: int,
                 random_flip: bool = True, crop_enabled: bool = False,
                 crop_type: str = "relative_range", crop_size: Sequence[float] = (0.9, 0.9),
                 gt_capacity: int = 100, num_classes: int = 20, size_divisibility: int = 64,
                 seed: int = 1234):
        self.min_size_train = list(min_size_train)
        self.max_size_train = max_size_train
        self.random_flip = random_flip
        self.crop_enabled = crop_enabled
        self.crop_type = crop_type
        self.crop_size = list(crop_size)
        self.gt_capacity = gt_capacity
        self.num_classes = num_classes
        self.size_divisibility = size_divisibility
        self.rng = np.random.RandomState(seed)
        self.strong_aug = build_strong_augmentation(seed + 1)

    @classmethod
    def from_cfg(cls, cfg) -> "DatasetMapperTwoCropSeparate":
        return cls(min_size_train=cfg.INPUT.MIN_SIZE_TRAIN, max_size_train=cfg.INPUT.MAX_SIZE_TRAIN,
                   random_flip=cfg.INPUT.RANDOM_FLIP != "none",
                   crop_enabled=cfg.INPUT.CROP.ENABLED, crop_type=cfg.INPUT.CROP.TYPE,
                   crop_size=cfg.INPUT.CROP.SIZE, gt_capacity=cfg.TPU.PGT_CAPACITY,
                   num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                   size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY, seed=max(cfg.SEED, 0))

    def __call__(self, d: dict) -> Tuple[Dict, Dict]:
        image = d.get("image")
        if image is None:
            image = read_image_bgr(d["file_name"])
        h, w = image.shape[:2]
        tl = []
        ch, cw = h, w
        if self.crop_enabled:
            tl.append(T.random_crop(h, w, self.crop_type, self.crop_size, self.rng))
            ch, cw = tl[-1].output_size
        tl.append(T.resize_shortest_edge(ch, cw, self.min_size_train, self.max_size_train,
                                         self.rng))
        ih, iw = tl[-1].output_size
        if self.random_flip and self.rng.rand() < 0.5:
            tl.append(T.HFlipTransform(ih, iw))
        tfm = T.TransformList(tl)

        weak = tfm.apply_image(image).astype(np.float32)
        ih, iw = weak.shape[:2]
        # the strong augmentations work on RGB uint8, as the reference's PIL path
        strong = self.strong_aug(weak[:, :, ::-1].astype(np.uint8))[:, :, ::-1].copy()

        cap = self.gt_capacity
        gt_boxes = np.zeros((cap, 4), np.float32)
        gt_classes = np.zeros((cap,), np.int32)
        gt_valid = np.zeros((cap,), bool)
        # crowd regions are the evaluator's ignore zones, never training gt
        anns = [a for a in d.get("annotations", []) if not a.get("iscrowd", 0)]
        boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        classes = np.asarray([a["category_id"] for a in anns], np.int64)
        if boxes.shape[0]:
            b = T.clip_boxes(tfm.apply_box(boxes), (ih, iw))
            keep = ((b[:, 2] - b[:, 0]) > 0) & ((b[:, 3] - b[:, 1]) > 0)
            b, classes = b[keep], classes[keep]
            n = min(b.shape[0], cap)
            gt_boxes[:n] = b[:n]
            gt_classes[:n] = classes[:n]
            gt_valid[:n] = True

        ml = np.zeros((self.num_classes,), np.float32)
        for c in d.get("multi_label", []) or []:
            ml[int(c)] = 1.0
        if not d.get("multi_label"):
            ml[np.unique(gt_classes[gt_valid])] = 1.0

        bh, bw = bucket_shape(ih, iw, self.size_divisibility)
        base = {"image_hw": np.array([ih, iw], np.float32), "gt_boxes": gt_boxes,
                "gt_classes": gt_classes, "gt_valid": gt_valid, "multi_label_oh": ml,
                "image_id": d.get("image_id"), "orig_hw": np.array([h, w], np.float32)}
        return (dict(base, image=pad_image(strong, bh, bw)),
                dict(base, image=pad_image(weak, bh, bw)))


def _pair_stream(dataset_dicts: List[dict], mapper, seed: int, rank: int = 0,
                 world: int = 1) -> Iterator[Tuple[Dict, Dict]]:
    for i in training_index_stream(len(dataset_dicts), seed, rank=rank, world=world):
        yield mapper(dataset_dicts[i])


def _repad_group(group: List[Dict], size_divisibility: int) -> List[Dict]:
    """The samples of ``group`` padded to the bucketed canvas of its largest."""
    bh, bw = bucket_shape(max(g["image"].shape[0] for g in group),
                          max(g["image"].shape[1] for g in group), size_divisibility)
    return [g if g["image"].shape[:2] == (bh, bw) else dict(g, image=pad_image(g["image"], bh, bw))
            for g in group]


def build_semisup_two_crop_loader(label_dicts: List[dict], unlabel_dicts: List[dict], mapper,
                                  batch_size_label: int, batch_size_unlabel: int, *,
                                  seed: int = 0, size_divisibility: int = 64, rank: int = 0,
                                  world: int = 1) -> Iterator[Dict[str, List[Dict]]]:
    """Infinite batches {label_q, label_k, unlabel_q, unlabel_k} (lists of
    samples; q strong, k weak) from process ``rank`` of ``world``'s share of
    the seeded index streams (labeled: ``seed``, unlabeled: ``seed + 1``).
    Raises when a stream that has to give images has none."""
    for name, dicts, n in (("labeled", label_dicts, batch_size_label),
                           ("unlabeled", unlabel_dicts, batch_size_unlabel)):
        if n > 0 and not dicts:
            raise ValueError(f"the {name} set is empty, but {n} {name} images a batch are asked "
                             "for (DATALOADER.SUP_PERCENT, SOLVER.IMG_PER_BATCH_*)")
    lbl = _pair_stream(label_dicts, mapper, seed, rank, world)
    ulb = _pair_stream(unlabel_dicts, mapper, seed + 1, rank, world)
    while True:
        lq, lk, uq, uk = [], [], [], []
        for _ in range(batch_size_label):
            s, w = next(lbl)
            lq.append(s)
            lk.append(w)
        for _ in range(batch_size_unlabel):
            s, w = next(ulb)
            uq.append(s)
            uk.append(w)
        # q and k of one stream share their geometry: one canvas for both
        lg = _repad_group(lq + lk, size_divisibility)
        ug = _repad_group(uq + uk, size_divisibility)
        yield {"label_q": lg[:batch_size_label], "label_k": lg[batch_size_label:],
               "unlabel_q": ug[:batch_size_unlabel], "unlabel_k": ug[batch_size_unlabel:]}


def build_semisup_loader_from_cfg(cfg, dataset_dicts: Optional[List[dict]] = None
                                  ) -> Iterator[Dict[str, List[Dict]]]:
    """The two-crop loader over DATASETS.TRAIN, divided by
    DATALOADER.SUP_PERCENT / RANDOM_DATA_SEED / RANDOM_DATA_SEED_PATH.
    SOLVER.IMG_PER_BATCH_LABEL / _UNLABEL are global batches; each process
    maps its 1/world share of them."""
    if dataset_dicts is None:
        dataset_dicts = get_detection_dataset_dicts(
            cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    label_dicts, unlabel_dicts = divide_label_unlabel(
        dataset_dicts, cfg.DATALOADER.SUP_PERCENT, cfg.DATALOADER.RANDOM_DATA_SEED,
        cfg.DATALOADER.RANDOM_DATA_SEED_PATH)
    rank, world = rank_and_world()
    bl, bu = cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL
    if bl % world or bu % world:
        raise ValueError(f"SOLVER.IMG_PER_BATCH_LABEL {bl} / _UNLABEL {bu} not divisible by "
                         f"{world} processes")
    return build_semisup_two_crop_loader(
        label_dicts, unlabel_dicts, DatasetMapperTwoCropSeparate.from_cfg(cfg), bl // world,
        bu // world, seed=max(cfg.SEED, 0), size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
        rank=rank, world=world)
