"""Training streams: dataset dicts -> mapped samples -> batches of one canvas.

Counterpart of ``training_index_stream`` and ``batched_stream`` in
``sos_wsod_tpu/data/build.py`` (detectron2's TrainingSampler and aspect-ratio
grouping): an infinite seeded shuffle, rank-strided across processes; mapped
4-view samples binned by aspect (tall vs wide) and proposal capacity, and each
batch re-padded to the largest bucketed canvas of its members, per scale.
"""
from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from .mapper_multi import bucket_shape, pad_image


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


_CANVAS_KEYS = ("images_s1", "images_s2")


def _repad_to(sample: Dict[str, np.ndarray], shapes: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """Grow a mapped sample's (2, H, W, 3) canvases to the per-key (bh, bw)."""
    out = dict(sample)
    for key, (bh, bw) in shapes.items():
        if out[key].shape[1:3] != (bh, bw):
            out[key] = np.stack([pad_image(im, bh, bw) for im in out[key]])
    return out


def batched_stream(dataset_dicts: List[dict],
                   mapper: Callable[[dict], Optional[Dict[str, np.ndarray]]],
                   batch_size: int, *, seed: int = 0, shuffle: bool = True,
                   size_divisibility: int = 64, num_workers: int = 0,
                   aspect_ratio_grouping: bool = True
                   ) -> Iterator[List[Dict[str, np.ndarray]]]:
    """Yield lists of ``batch_size`` mapped 4-view samples that share one
    canvas shape per scale. A mapper returning None skips the image. With
    ``num_workers`` > 0, ``mapper.plan(d)`` draws each image's random
    transforms on the calling thread in stream order and that many threads
    run the calls it returns, a window ahead of the consumer: the samples
    equal the serial path's."""
    stream = training_index_stream(len(dataset_dicts), seed, shuffle)

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
        h, w = s["images_s1"].shape[1:3]
        b = (int(h > w) if aspect_ratio_grouping else 0, s["prop_valid"].shape[-1])
        buckets.setdefault(b, []).append(s)
        if len(buckets[b]) == batch_size:
            group, buckets[b] = buckets[b], []
            shapes = {key: bucket_shape(max(g[key].shape[1] for g in group),
                                        max(g[key].shape[2] for g in group), size_divisibility)
                      for key in _CANVAS_KEYS}
            yield [_repad_to(g, shapes) for g in group]
