"""The port's training data path (sos_wsod_torch/data/transforms.py,
mapper_multi.py, build.py) against the JAX package's on the same dataset
dicts and seeds: numpy and PIL on both sides, the same random draws in the
same order, so every array is equal exactly.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from sos_wsod_tpu.data import transforms as jT
from sos_wsod_tpu.data.build import batched_stream as jax_batched_stream
from sos_wsod_tpu.data.build import training_index_stream as jax_training_index_stream
from sos_wsod_tpu.data.mapper_multi import DatasetMapperMultiInput as JaxMapper
from sos_wsod_torch.data import transforms as tT
from sos_wsod_torch.data.build import batched_stream, training_index_stream
from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
from sos_wsod_torch.engine.synthetic import synthetic_train_dicts

MAPPER = dict(min_size_train=(48, 56, 64, 80), max_size_train=120, crop_enabled=True,
              crop_type="relative_range", crop_size=(0.8, 0.8), proposal_topk=50,
              proposal_capacity=64, num_classes=20, size_divisibility=32, seed=7)


def _dicts():
    """Landscape and portrait images, one without labels (skipped), one
    whose proposals are all degenerate (skipped) and one with duplicates."""
    dicts = synthetic_train_dicts(5, (60, 90), 60, 20, 3) + synthetic_train_dicts(3, (85, 50), 60, 20, 4)
    dicts[2] = dict(dicts[2], annotations=[])
    dicts[4] = dict(dicts[4], proposal_boxes=np.tile([[10.0, 10.0, 10.0, 30.0]], (60, 1)))
    dicts[5]["proposal_boxes"][10:20] = dicts[5]["proposal_boxes"][0]
    return dicts


def _assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("buckets", [(), (32, 64)])
def test_mapper_matches_jax(buckets):
    """Each image, in sequence (the shared RandomState must advance alike),
    through both mappers: crop, the two scales with scale 2 drawn again
    until it differs, the flips, proposal dedup over the 4 views, capacity
    buckets and canvases."""
    port = DatasetMapperMultiInput(proposal_buckets=buckets, **MAPPER)
    ref = JaxMapper(proposal_buckets=buckets, **MAPPER)
    outs = [(port(d), ref(d)) for d in _dicts() * 2]
    for got, want in outs:
        _assert_same(got, want)
    assert sum(g is None for g, _ in outs) == 4
    assert len({g["images_s2"].shape for g, _ in outs if g is not None}) > 1


def test_resize_crop_flip_match_jax():
    rng_p, rng_j = np.random.RandomState(5), np.random.RandomState(5)
    image = np.random.RandomState(0).randint(0, 256, (70, 95, 3)).astype(np.uint8)
    boxes = np.random.RandomState(1).uniform(0, 90, (20, 4)).astype(np.float32)
    for crop_type, size in (("relative_range", (0.7, 0.8)), ("relative", (0.5, 0.9)),
                            ("absolute", (40, 60)), ("absolute_range", (30, 50))):
        tp = tT.random_crop(70, 95, crop_type, size, rng_p)
        tj = jT.random_crop(70, 95, crop_type, size, rng_j)
        rp = tT.resize_shortest_edge(*tp.output_size, [40, 48, 64], 100, rng_p)
        rj = jT.resize_shortest_edge(*tj.output_size, [40, 48, 64], 100, rng_j)
        fp, fj = tT.HFlipTransform(*rp.output_size), jT.HFlipTransform(*rj.output_size)
        got, want = tT.TransformList([tp, rp, fp]), jT.TransformList([tj, rj, fj])
        assert got.output_size == want.output_size
        np.testing.assert_array_equal(got.apply_image(image), want.apply_image(image))
        np.testing.assert_array_equal(got.apply_box(boxes), want.apply_box(boxes))
    assert isinstance(tT.resize_shortest_edge(10, 20, 0, 100), tT.NoOpTransform)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_training_index_stream_matches_jax(rank, world):
    got = list(itertools.islice(training_index_stream(7, 3, True, rank, world), 30))
    want = list(itertools.islice(jax_training_index_stream(7, 3, True, rank, world), 30))
    assert got == want


@pytest.mark.parametrize("num_workers", [0, 3])
def test_batched_stream_matches_jax(num_workers):
    """Batches of 2 grouped by aspect and proposal capacity, each re-padded
    to its members' largest canvas per scale; mapper None skips an image.
    With threads the port draws each image's transforms in stream order
    (``plan``), so it still equals the serial JAX stream."""
    dicts = _dicts()
    kw = dict(seed=11, size_divisibility=32)
    port = batched_stream(dicts, DatasetMapperMultiInput(**MAPPER), 2,
                          num_workers=num_workers, **kw)
    ref = jax_batched_stream(dicts, JaxMapper(**MAPPER), 2, **kw)
    for _ in range(6):
        got, want = next(port), next(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g, w)
        assert got[0]["images_s1"].shape == got[1]["images_s1"].shape
    port.close()


def test_mapper_plan_reads_size_from_dict(tmp_path):
    """A dict with ``file_name``, ``height`` and ``width`` plans without
    reading the image, maps like the in-memory image, and a wrong size
    raises when the image is read."""
    from PIL import Image

    d = synthetic_train_dicts(1, (60, 90), 60, 20, 5)[0]
    path = tmp_path / "img.png"
    Image.fromarray(d["image"][:, :, ::-1]).save(path)
    on_disk = {k: v for k, v in d.items() if k != "image"}
    _assert_same(DatasetMapperMultiInput(**MAPPER).plan(dict(on_disk, file_name=str(path),
                                                             height=60, width=90))(),
                 DatasetMapperMultiInput(**MAPPER)(d))
    with pytest.raises(ValueError, match="its dict says"):
        DatasetMapperMultiInput(**MAPPER).plan(dict(on_disk, file_name=str(path),
                                                    height=61, width=90))()
