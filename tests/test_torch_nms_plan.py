"""The plan of the CUDA greedy NMS (sos_wsod_torch/csrc/nms.cu), emulated in
numpy on the CPU, against the plain fixpoint (ops/nms.py), the numpy greedy
oracle (tests/oracles.py:nms_np) and the reference golden; and the port's
batched_nms_mask and keep_top_k against the JAX package's.

The emulation computes each pair's suppression bit with the kernel's f32
operations (numpy float32 arithmetic rounds each step to nearest, as the
kernel's __f*_rn intrinsics do), packs the bits into the kernel's 64-bit
words on and above the diagonal (the words below hold garbage, which the
sweep must never read), then walks them as the sweep kernel does: 64 boxes
a word decided in order, then the kept rows' later words ORed into the
"removed" bitset. Keep masks are compared exactly: the inputs carry chains
of suppression, exact score ties, pairs exactly at the threshold,
duplicates, empty boxes and invalid slots (tools/bench_nms.py:nms_case).
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import nms_np
from sos_wsod_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from sos_wsod_tpu.ops.nms import keep_top_k as jax_keep_top_k
from sos_wsod_torch.kernels import nms as kernel
from sos_wsod_torch.ops.nms import (
    batched_nms_mask,
    greedy_keep_sorted_reference,
    keep_top_k,
    nms_mask,
)
from sos_wsod_torch.tools.bench_nms import SHAPES, nms_case, sorted_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLD = ROOT / "tests" / "goldens"
TILE = 64


def test_tile_matches_the_source():
    src = (ROOT / "sos_wsod_torch" / "csrc" / "nms.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == kernel.TILE == TILE


def _suppress_bits(b: np.ndarray, thr: float) -> np.ndarray:
    """(S, S) bool, [i, j]: IoU(i, j) > thr and j > i, by the kernel's f32
    steps: max/min of the corners, (rb - lt) clamped at 0, w * h,
    (area_i + area_j) - inter, the union guard, inter / union."""
    f0 = np.float32(0)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        w = np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0])
        h = np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1])
        w = np.where(w < 0, f0, w)
        h = np.where(h < 0, f0, h)
        inter = w * h
        union = (area[:, None] + area[None, :]) - inter
        safe = np.where(union > 0, union, np.float32(1))
        iou = np.where(inter > 0, inter / safe, f0)
    assert iou.dtype == np.float32
    s = b.shape[0]
    return (iou > np.float32(thr)) & np.triu(np.ones((s, s), bool), 1)


def _mask_words(b: np.ndarray, thr: float, rng) -> np.ndarray:
    """The mask kernel's output: (S, W) uint64, bit t of word w of row i =
    box i suppresses box 64 w + t; words below the diagonal are garbage."""
    s = b.shape[0]
    words = -(-s // TILE)
    bits = np.zeros((s, words * TILE), bool)
    bits[:, :s] = _suppress_bits(b, thr)
    weights = np.uint64(1) << np.arange(TILE, dtype=np.uint64)
    packed = (bits.reshape(s, words, TILE).astype(np.uint64) * weights).sum(-1, dtype=np.uint64)
    below = np.arange(words)[None, :] < (np.arange(s) // TILE)[:, None]
    garbage = rng.integers(0, 2**63, packed.shape, dtype=np.int64).astype(np.uint64)
    return np.where(below, garbage, packed)


def _sweep(mask: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The sweep kernel's walk over one problem."""
    s, words = mask.shape
    removed = [0] * words
    keep = np.zeros(s, bool)
    for wb in range(words):
        rows = range(wb * TILE, min(s, (wb + 1) * TILE))
        live = sum(1 << (r - wb * TILE) for r in rows if valid[r])
        cur, kw = removed[wb], 0
        for t in range(TILE):
            if ((live & ~cur) >> t) & 1:
                kw |= 1 << t
                cur |= int(mask[wb * TILE + t, wb])
        for t in range(TILE):
            if (kw >> t) & 1:
                keep[wb * TILE + t] = True
                for w in range(wb + 1, words):
                    removed[w] |= int(mask[wb * TILE + t, w])
    return keep


def _emulated_keep_sorted(b: np.ndarray, v: np.ndarray, thr: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_sweep(_mask_words(b[i], thr, rng), v[i]) for i in range(b.shape[0])])


CASES = [(name, 2, 200, thr) for name, (_, _, thr) in SHAPES.items()] + [
    ("stage-1 mining", 1, 1024, 0.01), ("stage-2 RPN", 1, 1100, 0.7),
    ("stage-2 box head", 1, 1000, 0.5), ("ragged", 3, 65, 0.3)]


@pytest.mark.parametrize("name,batch,s,thr", CASES)
def test_emulated_kernels_match_plain_fixpoint_and_oracle(name, batch, s, thr):
    """The emulated keep mask equals the plain fixpoint's (the kernel's
    counterpart on the CPU) and the numpy greedy oracle's on the valid
    boxes, through nms_mask's sort and scatter."""
    boxes, scores, valid = nms_case(batch, s, thr, seed=s + batch)
    b, v = sorted_inputs(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid))
    emulated = _emulated_keep_sorted(b.numpy(), v.numpy(), thr)
    np.testing.assert_array_equal(emulated, greedy_keep_sorted_reference(b, v, thr).numpy())
    assert 0 < emulated.sum() < v.sum()          # something kept, something suppressed
    keep = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
                    thr).numpy()
    for i in range(batch):
        want = np.zeros(s, bool)
        want[valid[i]] = nms_np(boxes[i][valid[i]], scores[i][valid[i]], thr)
        np.testing.assert_array_equal(keep[i], want)


def test_case_has_exact_ties_and_threshold_pairs():
    """The inputs hold what they claim: tied scores, pairs at IoU exactly
    the f32 threshold (kept apart, since suppression needs IoU > thr), and a
    chain deeper than a few fixpoint iterations."""
    thr = 0.3
    boxes, scores, valid = nms_case(1, 300, thr, seed=1)
    assert len(np.unique(scores[0])) < 30
    b = boxes[0]
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    inter = np.minimum(b[:, None, 2:], b[None, :, 2:]) - np.maximum(b[:, None, :2], b[None, :, :2])
    inter = np.clip(inter, 0, None).prod(-1)
    iou = inter / (area[:, None] + area[None, :] - inter + 1e-30)
    assert (iou == np.float32(thr)).sum() >= 10
    suppress = _suppress_bits(b, thr)
    assert not suppress[iou == np.float32(thr)].any()


def _golden_dets():
    z = np.load(GOLD / "nms.npz")
    d = z["dets0"]
    xyxy = np.stack([d[:, 0] - d[:, 2] / 2, d[:, 1] - d[:, 3] / 2,
                     d[:, 0] + d[:, 2] / 2, d[:, 1] + d[:, 3] / 2], 1).astype(np.float32)
    return z, xyxy


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_emulated_kernels_match_reference_golden(thr):
    """tests/goldens/nms.npz: the reference's greedy keep set on unique
    scores, through the emulated kernels."""
    z, xyxy = _golden_dets()
    b, v = sorted_inputs(torch.from_numpy(xyxy)[None], torch.from_numpy(z["scores"])[None],
                         torch.ones(1, len(xyxy), dtype=torch.bool))
    order = torch.sort(torch.from_numpy(z["scores"]), descending=True, stable=True).indices
    keep_sorted = _emulated_keep_sorted(b.numpy(), v.numpy(), thr)[0]
    got = set(order[torch.from_numpy(keep_sorted)].tolist())
    assert got == set(z["keep0_%d" % int(thr * 100)].tolist())


@pytest.mark.parametrize("thr", [0.01, 0.3, 0.5])
def test_emulated_kernels_match_reference_golden_ties(thr):
    """The golden's heavy-tie case: the reference's tie-resolved order as
    unique surrogate scores (as tests/test_reference_goldens.py does)."""
    z, xyxy = _golden_dets()
    order = z["order_tied"]
    surrogate = np.empty(len(order), np.float32)
    surrogate[order] = np.arange(len(order), 0, -1, dtype=np.float32)
    b, v = sorted_inputs(torch.from_numpy(xyxy)[None], torch.from_numpy(surrogate)[None],
                         torch.ones(1, len(xyxy), dtype=torch.bool))
    keep_sorted = _emulated_keep_sorted(b.numpy(), v.numpy(), thr)[0]
    got = set(np.asarray(order)[keep_sorted].tolist())
    assert got == set(z["keep_tied_%d" % int(thr * 100)].tolist())


@pytest.mark.parametrize("thr,n_levels", [(0.7, 5), (0.5, 20), (0.3, 1)])
def test_batched_nms_mask_matches_jax(thr, n_levels):
    """The offset trick: the shift is max over valid coordinates only, + 1;
    keep sets equal, with tied scores and invalid slots."""
    boxes, scores, valid = nms_case(1, 240, thr, seed=n_levels)
    idxs = np.random.default_rng(n_levels).integers(0, n_levels, 240).astype(np.int32)
    boxes[0, ~valid[0]] += 5000.0      # invalid boxes far out must not set the offset
    got = batched_nms_mask(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                           torch.from_numpy(idxs), torch.from_numpy(valid[0]), thr).numpy()
    want = np.asarray(jax_batched_nms_mask(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                                           jnp.asarray(idxs), jnp.asarray(valid[0]), thr))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("k", [1, 7, 40, 200])
def test_keep_top_k_matches_jax(k):
    """Ties at the k-th kept score are taken in index order up to k."""
    rng = np.random.default_rng(k)
    scores = np.round(rng.uniform(0, 1, 200), 1).astype(np.float32)
    keep = rng.uniform(0, 1, 200) > 0.3
    got = keep_top_k(torch.from_numpy(scores), torch.from_numpy(keep), k).numpy()
    want = np.asarray(jax_keep_top_k(jnp.asarray(scores), jnp.asarray(keep), k))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == min(k, keep.sum())


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernels' wrappers take CUDA tensors only."""
    with pytest.raises(ValueError, match="CUDA"):
        kernel.nms_mask_words_cuda(torch.zeros(1, 4, 4), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.nms_sweep_cuda(torch.zeros(1, 4, 1, dtype=torch.int64),
                              torch.ones(1, 4, dtype=torch.bool))


def test_traffic_bytes():
    """Boxes, valid flags, the mask words on and above the diagonal written
    and read once, the keep flags: 64 W (W + 1) / 2 words a problem."""
    assert kernel.traffic_bytes(1, 64) == 16 * 64 + 64 + 2 * 8 * 64 + 64
    assert kernel.traffic_bytes(20, 4096) == 20 * (18 * 4096 + 16 * 64 * 64 * 65 // 2)
