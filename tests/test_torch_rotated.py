"""The port's rotated-box ops (sos_wsod_torch/ops/rotated.py) against the JAX
package's (sos_wsod_tpu/ops/rotated.py) and the reference golden nms.npz, on
the CPU.

Tolerances: the corners and the rotated IoU within 1e-5 of JAX's (two f32
implementations of the same 8-vertex clip: the port takes the angle's
cosine and sine in f64, rounded to f32, and sums in a fixed order, so that
the card gives the CPU's bits); the IoU within 2e-4 of the
reference's kernel (double accumulation), as the JAX package's own golden
test holds it. Keep sets equal JAX's, except where a pair's IoU lies within
1e-5 of the threshold: the test names such pairs, and a box may differ
only if it is in one. Against the golden's keep_r50, the JAX test's
allowance (max(2, 2%) boxes).

The card path (kernel C's sweep over the suppression relation packed by
``kernels/nms.py:suppression_words``) is emulated here with the sweep's
numpy walk from tests/test_torch_nms_plan.py.
"""
from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.ops import rotated as jax_rotated
from sos_wsod_torch.kernels.nms import suppression_words
from sos_wsod_torch.ops import rotated
from sos_wsod_torch.ops.nms import greedy_keep_from_suppression
from test_torch_nms_plan import _sweep

GOLD = pathlib.Path(__file__).resolve().parent / "goldens" / "nms.npz"


def _boxes(rng, n, span=60.0, angles=True):
    a = rng.uniform(-180, 180, (n, 1)) if angles else np.zeros((n, 1))
    return np.concatenate([rng.uniform(0, span, (n, 2)), rng.uniform(4, 30, (n, 2)), a],
                          1).astype(np.float32)


def _special():
    """Identical, 45-degree, 180-degree-turned, disjoint, touching and
    degenerate boxes."""
    return np.array([[0, 0, 1, 1, 0], [0, 0, 1, 1, 45], [10, 20, 8, 4, 30], [10, 20, 8, 4, 210],
                     [100, 100, 2, 2, 60], [5, 0, 4, 4, 0], [9, 0, 4, 4, 0], [3, 3, 0, 5, 10],
                     [0, 0, 1, 1, 90], [0.5, 0, 1, 1, 0]], np.float32)


def test_box_to_corners_matches_jax():
    rng = np.random.default_rng(0)
    b = np.concatenate([_boxes(rng, 50), _special()])
    got = rotated.box_to_corners(torch.from_numpy(b)).numpy()
    want = np.asarray(jax_rotated.box_to_corners(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,angles", [(0, True), (1, True), (2, False)])
def test_pairwise_iou_rotated_matches_jax(seed, angles):
    rng = np.random.default_rng(seed)
    b1 = np.concatenate([_boxes(rng, 40, angles=angles), _special()])
    b2 = np.concatenate([_boxes(rng, 33, angles=angles), _special()])
    got = rotated.pairwise_iou_rotated(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    want = np.asarray(jax_rotated.pairwise_iou_rotated(jnp.asarray(b1), jnp.asarray(b2)))
    assert got.dtype == np.float32 and got.shape == (len(b1), len(b2))
    assert (want > 0.05).sum() > 50, "too few overlapping pairs to test"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pairwise_iou_rotated_chunks(monkeypatch):
    """The pairs computed in chunks of rows give the one-chunk matrix."""
    rng = np.random.default_rng(3)
    b1, b2 = torch.from_numpy(_boxes(rng, 13)), torch.from_numpy(_boxes(rng, 7))
    whole = rotated.pairwise_iou_rotated(b1, b2)
    monkeypatch.setattr(rotated, "PAIR_CHUNK", 20)
    assert torch.equal(rotated.pairwise_iou_rotated(b1, b2), whole)


def test_pairwise_iou_rotated_matches_reference_golden():
    z = np.load(GOLD)
    d = torch.from_numpy(z["dets_r"])
    got = rotated.pairwise_iou_rotated(d[:64], d[64:128]).numpy()
    np.testing.assert_allclose(got, z["iou_r"], rtol=2e-4, atol=2e-4)


def _near_threshold_pairs(boxes, thr):
    """(i, j) pairs whose JAX rotated IoU lies within 1e-5 of ``thr``."""
    iou = np.asarray(jax_rotated.pairwise_iou_rotated(jnp.asarray(boxes), jnp.asarray(boxes)))
    return {(i, j) for i, j in zip(*np.nonzero(np.abs(iou - thr) <= 1e-5)) if i != j}


def _check_keep(got, want, boxes, thr):
    diff = set(np.nonzero(got != want)[0].tolist())
    near = _near_threshold_pairs(boxes, thr)
    named = {i for pair in near for i in pair}
    assert diff <= named, (f"keep sets differ at {sorted(diff - named)} with no pair within "
                           f"1e-5 of {thr}; pairs near it: {sorted(near)}")


def _case(seed, n=120):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, n)
    boxes[: n // 4] = boxes[n // 4: n // 2] + rng.normal(0, 1, (n // 4, 5)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[:10] = scores[10:20]                         # exact score ties
    valid = rng.uniform(0, 1, n) > 0.1
    return boxes, scores, valid


def test_nms_rotated_mask_matches_jax_on_golden():
    z = np.load(GOLD)
    d, scores = z["dets_r"], z["scores"]
    valid = np.ones(len(d), bool)
    got = rotated.nms_rotated_mask(torch.from_numpy(d), torch.from_numpy(scores),
                                   torch.from_numpy(valid), 0.5).numpy()
    want = np.asarray(jax_rotated.nms_rotated_mask(jnp.asarray(d), jnp.asarray(scores),
                                                   jnp.asarray(valid), 0.5))
    _check_keep(got, want, d, 0.5)
    sym = set(np.nonzero(got)[0].tolist()) ^ set(z["keep_r50"].tolist())
    assert len(sym) <= max(2, len(z["keep_r50"]) // 50), sym


@pytest.mark.parametrize("seed,thr", [(0, 0.5), (1, 0.3), (2, 0.7)])
def test_nms_rotated_mask_matches_jax(seed, thr):
    boxes, scores, valid = _case(seed)
    got = rotated.nms_rotated_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                   torch.from_numpy(valid), thr).numpy()
    want = np.asarray(jax_rotated.nms_rotated_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                                   jnp.asarray(valid), thr))
    assert 0 < want.sum() < valid.sum()
    _check_keep(got, want, boxes, thr)


@pytest.mark.parametrize("seed", [3, 4])
def test_batched_nms_rotated_matches_jax(seed):
    boxes, scores, valid = _case(seed)
    idxs = np.random.default_rng(seed).integers(0, 3, len(boxes))
    got = rotated.batched_nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores),
                                      torch.from_numpy(idxs), torch.from_numpy(valid), 0.5)
    want = np.asarray(jax_rotated.batched_nms_rotated(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), jnp.asarray(valid), 0.5))
    span = np.abs(boxes[:, 0]).max() + np.abs(boxes[:, 1]).max() + (boxes[:, 2] + boxes[:, 3]).max() + 1
    shifted = boxes.copy()
    shifted[:, 0] += idxs * span
    _check_keep(got.numpy(), want, shifted, 0.5)
    assert rotated.batched_nms_rotated(torch.zeros((0, 5)), torch.zeros(0), torch.zeros(0),
                                       torch.zeros(0, dtype=torch.bool), 0.5).shape == (0,)


@pytest.mark.parametrize("seed,n", [(0, 120), (5, 300), (6, 64), (7, 65)])
def test_sweep_on_packed_rotated_suppression_equals_fixpoint(seed, n):
    """The card path: the rotated suppression relation packed into kernel
    C's words, walked as the sweep kernel walks them, keeps what the plain
    fixpoint keeps."""
    boxes, scores, valid = _case(seed, n)
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    b = torch.from_numpy(boxes[order])
    v = torch.from_numpy(valid[order])
    suppress = (rotated.pairwise_iou_rotated(b, b) > 0.5) & torch.ones(n, n, dtype=torch.bool).triu(1)
    words = suppression_words(suppress[None])
    assert words.shape == (1, n, -(-n // 64)) and words.dtype == torch.int64
    want = greedy_keep_from_suppression(suppress, v).numpy()
    got = _sweep(words[0].numpy().view(np.uint64), v.numpy())
    np.testing.assert_array_equal(got, want)
    # the words hold the relation bit for bit
    bits = (words[0].numpy().view(np.uint64)[:, :, None] >> np.arange(64, dtype=np.uint64)) & 1
    np.testing.assert_array_equal(bits.reshape(n, -1)[:, :n].astype(bool), suppress.numpy())


def test_nms_rotated_refuses_other_devices():
    with pytest.raises(ValueError, match="no implementation"):
        rotated.nms_rotated_mask(torch.zeros((2, 5), device="meta"), torch.zeros(2, device="meta"),
                                 torch.ones(2, dtype=torch.bool, device="meta"), 0.5)


def test_vertex_count_past_the_buffer_clamps_as_jax():
    """Rounding can emit a 9th vertex where an exact clip emits 8; the
    successor index then clamps to the buffer as JAX's gather clamps it
    (a CUDA gather out of range would abort)."""
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(8, 2)).astype(np.float32)
    a, b, c = np.float32(0.6), np.float32(-0.8), np.float32(0.1)
    want_pts, want_cnt = jax_rotated._clip_by_halfplane(jnp.asarray(pts), 9, a, b, c)
    got_pts, got_cnt = rotated._clip_by_halfplane(
        torch.from_numpy(pts)[None], torch.tensor([9], dtype=torch.int32), torch.tensor([a]),
        torch.tensor([b]), torch.tensor([c]))
    assert int(got_cnt[0]) == int(want_cnt)
    np.testing.assert_allclose(got_pts[0].numpy(), np.asarray(want_pts), rtol=0, atol=1e-6)
    want_area = float(jax_rotated._polygon_area(jnp.asarray(pts), 9))
    got_area = float(rotated._polygon_area(torch.from_numpy(pts)[None],
                                           torch.tensor([9], dtype=torch.int32))[0])
    np.testing.assert_allclose(got_area, want_area, rtol=1e-6)
