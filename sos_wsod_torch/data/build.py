"""Data loaders: registered datasets -> dataset dicts -> mapped samples.

Counterpart of ``sos_wsod_tpu/data/build.py`` (detectron2's
get_detection_dataset_dicts, TrainingSampler and aspect-ratio grouping):
  - ``get_detection_dataset_dicts``: the catalog's dicts with their
    precomputed proposals, images without annotations dropped on request;
  - training: an infinite seeded shuffle, rank-strided across processes;
    mapped samples (4-view, or single-view for GeneralizedRCNNWSL) binned by
    aspect (tall vs wide) and proposal capacity, each batch re-padded to the
    largest bucketed canvas of its members, per scale;
  - test: ``DatasetMapperTest``, one resized image and its proposals per
    sample, in dataset order.
Rank and world size are the data-parallel ones (``rank_and_world``): the
process's in ``torch.distributed`` when it is initialized, the replica's
under tensor parallelism.
"""
from __future__ import annotations

import itertools
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.boxes import unique_boxes_keep_mask
from . import transforms as T
from .catalog import DatasetCatalog
from .mapper_multi import (
    DatasetMapperMultiInput,
    DatasetMapperSingle,
    _nonempty,
    bucket_shape,
    pad_image,
    pick_capacity,
    read_image_bgr,
)
from .proposals import load_proposals_into_dataset

logger = logging.getLogger(__name__)


def get_detection_dataset_dicts(names: Sequence[str], filter_empty: bool = True,
                                proposal_files: Optional[Sequence[str]] = None) -> List[dict]:
    """The dicts of the registered datasets ``names``, in order, with the
    proposals of ``proposal_files`` (one per dataset) merged in; with
    ``filter_empty``, images without annotations are dropped."""
    if isinstance(names, str):
        names = [names]
    dicts_per = [DatasetCatalog.get(n) for n in names]
    if proposal_files:
        if len(proposal_files) != len(names):
            raise ValueError(f"{len(proposal_files)} proposal files for {len(names)} datasets")
        dicts_per = [load_proposals_into_dataset(d, f) for d, f in zip(dicts_per, proposal_files)]
    dataset_dicts = list(itertools.chain.from_iterable(dicts_per))
    if filter_empty and all("annotations" in d for d in dataset_dicts):
        before = len(dataset_dicts)
        dataset_dicts = [d for d in dataset_dicts if len(d.get("annotations", []))]
        logger.info("Removed %d images with no annotations", before - len(dataset_dicts))
    return dataset_dicts


def rank_and_world() -> Tuple[int, int]:
    """This process's data-parallel rank and their number: the process's
    rank and the world size (``parallel/comm.py``), (0, 1) outside a
    process group; under tensor parallelism the replica's
    (``parallel/tensor.py``), shared by the ranks of a tensor-parallel
    group, which map the same images."""
    from ..parallel import tensor

    return tensor.data_rank(), tensor.data_world_size()


def training_index_stream(n: int, seed: int = 0, shuffle: bool = True, rank: int = 0,
                          world: int = 1) -> Iterator[int]:
    """Infinite shuffled index stream; process ``rank`` of ``world`` keeps
    every world-th index of the same seeded stream, from its rank on."""
    assert 0 <= rank < world

    def gen():
        rng = np.random.RandomState(seed)
        while True:
            yield from (rng.permutation(n) if shuffle else np.arange(n)).tolist()

    return itertools.islice(gen(), rank, None, world) if world > 1 else gen()


def _canvases(sample: Dict[str, np.ndarray]) -> Dict[str, Tuple[int, int]]:
    """A mapped sample's canvas sizes by key: the multi-input views'
    (2, H, W, 3) images of each scale, or the single view's (H, W, 3)."""
    if "images_s1" in sample:
        return {k: sample[k].shape[1:3] for k in ("images_s1", "images_s2")}
    return {"image": sample["image"].shape[:2]}


def _repad_to(sample: Dict[str, np.ndarray], shapes: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """Grow a mapped sample's canvases to the per-key (bh, bw)."""
    out = dict(sample)
    for key, (bh, bw) in shapes.items():
        if _canvases(out)[key] != (bh, bw):
            im = out[key]
            out[key] = (pad_image(im, bh, bw) if im.ndim == 3
                        else np.stack([pad_image(v, bh, bw) for v in im]))
    return out


def batched_stream(dataset_dicts: List[dict],
                   mapper: Callable[[dict], Optional[Dict[str, np.ndarray]]],
                   batch_size: int, *, seed: int = 0, shuffle: bool = True,
                   size_divisibility: int = 64, num_workers: int = 0,
                   aspect_ratio_grouping: bool = True, rank: int = 0, world: int = 1
                   ) -> Iterator[List[Dict[str, np.ndarray]]]:
    """Yield lists of ``batch_size`` mapped samples (4-view or single-view)
    that share one canvas shape per scale, from process ``rank`` of ``world``'s share of
    the index stream. A mapper returning None skips the image. With
    ``num_workers`` > 0, ``mapper.plan(d)`` draws each image's random
    transforms on the calling thread in stream order and that many threads
    run the calls it returns, a window ahead of the consumer: the samples
    equal the serial path's."""
    stream = training_index_stream(len(dataset_dicts), seed, shuffle, rank, world)

    def mapped():
        if num_workers > 0:
            ex = ThreadPoolExecutor(num_workers)
            try:
                futs = [ex.submit(mapper.plan(dataset_dicts[next(stream)]))
                        for _ in range(2 * max(num_workers, batch_size))]
                while True:
                    fut = futs.pop(0)
                    futs.append(ex.submit(mapper.plan(dataset_dicts[next(stream)])))
                    s = fut.result()
                    if s is not None:
                        yield s
            finally:
                ex.shutdown(wait=False, cancel_futures=True)
        else:
            for i in stream:
                s = mapper(dataset_dicts[i])
                if s is not None:
                    yield s

    buckets: Dict[tuple, List[Dict[str, np.ndarray]]] = {}
    for s in mapped():
        h, w = next(iter(_canvases(s).values()))
        b = (int(h > w) if aspect_ratio_grouping else 0, s["prop_valid"].shape[-1])
        buckets.setdefault(b, []).append(s)
        if len(buckets[b]) == batch_size:
            group, buckets[b] = buckets[b], []
            sizes = [_canvases(g) for g in group]
            shapes = {key: bucket_shape(max(c[key][0] for c in sizes),
                                        max(c[key][1] for c in sizes), size_divisibility)
                      for key in sizes[0]}
            yield [_repad_to(g, shapes) for g in group]


def build_stage1_train_loader(cfg, mapper=None):
    """Infinite stream of stage-1 batches over DATASETS.TRAIN with their
    proposal files: 4-view samples for MultiInputRCNN, single-view ones
    (``DatasetMapperSingle``) for any other MODEL.META_ARCHITECTURE, as in
    the JAX package. SOLVER.IMS_PER_BATCH is the global batch; each process
    maps its 1/world share of it."""
    if mapper is None:
        mapper = (DatasetMapperMultiInput if cfg.MODEL.META_ARCHITECTURE == "MultiInputRCNN"
                  else DatasetMapperSingle).from_cfg(cfg)
    dataset_dicts = get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN, filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
        proposal_files=cfg.DATASETS.PROPOSAL_FILES_TRAIN if cfg.MODEL.LOAD_PROPOSALS else None)
    rank, world = rank_and_world()
    if cfg.SOLVER.IMS_PER_BATCH % world:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} is not divisible "
                         f"by {world} processes")
    return batched_stream(dataset_dicts, mapper, cfg.SOLVER.IMS_PER_BATCH // world,
                          seed=max(cfg.SEED, 0), size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
                          num_workers=cfg.DATALOADER.NUM_WORKERS,
                          aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING,
                          rank=rank, world=world)


class DatasetMapperTest:
    """Single-view inference mapper: ResizeShortestEdge(MIN_SIZE_TEST) with
    MAX_SIZE_TEST, no flip; all proposals transformed, clipped, kept when
    unique and non-empty, then the top ``proposal_topk`` padded to the
    smallest proposal bucket that holds them (else ``proposal_capacity``).
    Returns the keys of ``MultiInputRCNN.predict`` plus image_id and
    orig_hw."""

    def __init__(self, *, min_size_test: int, max_size_test: int, proposal_topk: int = 1000,
                 proposal_capacity: int = 4096, proposal_buckets: Sequence[int] = (),
                 size_divisibility: int = 64):
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test
        self.proposal_topk = proposal_topk
        self.capacity = proposal_capacity
        self.proposal_buckets = tuple(sorted(int(b) for b in proposal_buckets))
        self.size_divisibility = size_divisibility

    @classmethod
    def from_cfg(cls, cfg) -> "DatasetMapperTest":
        return cls(min_size_test=cfg.INPUT.MIN_SIZE_TEST, max_size_test=cfg.INPUT.MAX_SIZE_TEST,
                   proposal_topk=cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST,
                   proposal_capacity=cfg.TPU.PROPOSAL_CAPACITY,
                   proposal_buckets=cfg.TPU.PROPOSAL_BUCKETS,
                   size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY)

    def __call__(self, d: dict) -> Dict[str, np.ndarray]:
        image = d.get("image")
        if image is None:
            image = read_image_bgr(d["file_name"])
        h, w = image.shape[:2]
        t = T.resize_shortest_edge(h, w, [self.min_size_test], self.max_size_test)
        img = t.apply_image(image)
        ih, iw = img.shape[:2]
        bh, bw = bucket_shape(ih, iw, self.size_divisibility)
        cap, n = self.capacity, 0
        if "proposal_boxes" in d:
            raw = np.asarray(d["proposal_boxes"], np.float32)
            logits = np.asarray(d["proposal_objectness_logits"], np.float32)[:raw.shape[0]]
            b = T.clip_boxes(t.apply_box(raw), (ih, iw))
            keep = unique_boxes_keep_mask(b) & _nonempty(b)
            b, logits = b[keep][:self.proposal_topk], logits[keep][:self.proposal_topk]
            cap = pick_capacity(b.shape[0], self.proposal_buckets, self.capacity)
            n = min(b.shape[0], cap)
        boxes = np.zeros((cap, 4), np.float32)
        objectness = np.zeros((cap,), np.float32)
        if n:
            boxes[:n], objectness[:n] = b[:n], logits[:n]
        return {
            "image": pad_image(img.astype(np.float32), bh, bw),
            "valid_hw": np.array([ih, iw], np.int32),
            "boxes": boxes,
            "objectness": objectness,
            "prop_valid": np.arange(cap) < n,
            "image_hw": np.array([ih, iw], np.float32),
            "image_id": d.get("image_id"),
            "orig_hw": np.array([h, w], np.float32),
        }


def build_stage1_test_loader(cfg, dataset_name: str, mapper=None,
                             shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
    """The mapped test samples of ``dataset_name`` in dataset order, with
    its entry of DATASETS.PROPOSAL_FILES_TEST when it is one of
    DATASETS.TEST and MODEL.LOAD_PROPOSALS is set; with ``shard`` (r, n)
    only the images whose index is r mod n."""
    proposal_files = None
    tests = list(cfg.DATASETS.TEST)
    if cfg.MODEL.LOAD_PROPOSALS and dataset_name in tests and cfg.DATASETS.PROPOSAL_FILES_TEST:
        proposal_files = [cfg.DATASETS.PROPOSAL_FILES_TEST[tests.index(dataset_name)]]
    dataset_dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False,
                                                proposal_files=proposal_files)
    mapper = mapper or DatasetMapperTest.from_cfg(cfg)
    return (mapper(d) for d in dataset_dicts[shard[0]::shard[1]])
