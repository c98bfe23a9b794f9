"""The plan of the CUDA greedy NMS (sos_wsod_torch/csrc/nms.cu), emulated in
numpy on the CPU, against the plain fixpoint (ops/nms.py), the numpy greedy
oracle (tests/oracles.py:nms_np) and the reference golden; the mask kernel's
divide-free compare against the f32 divide; and the port's batched_nms_mask
and keep_top_k against the JAX package's.

The emulation computes each pair's suppression bit as the mask kernel does:
the f32 steps of the IoU up to the guarded union (numpy float32 arithmetic
rounds each step to nearest, as the kernel's __f*_rn intrinsics do), then
inter > m * safe in f64 with the host's threshold constants instead of the
divide; a column box with a NaN, an invalid one and the ragged edge staged as
the empty box, a row box with a NaN given the bits of IoU 0. It packs the
bits into 64-bit words on and above the diagonal, and only in the tiles that
hold a valid row and a valid column: the other words hold garbage, which the
sweep must never read or only read for invalid boxes. Then it walks them as
the sweep kernel does, up to the last word that holds a valid box: warp 0
decides the 64 boxes of a word as the fixpoint of its candidates (valid and
not in the removed bitset or its carry, the kept rows' next word) against
their diagonal words and lists the kept rows, and the workers OR the listed
rows of the step before into the words after that. Keep masks are compared
exactly: the inputs carry chains of suppression, exact
score ties, pairs exactly at the threshold, duplicates, empty boxes and
invalid slots (tools/bench_nms.py:nms_case).
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
from sos_wsod_torch.core.boxes import pairwise_iou
from sos_wsod_torch.kernels import nms as kernel
from sos_wsod_torch.ops.nms import (
    batched_nms_mask,
    greedy_keep_sorted_reference,
    keep_top_k,
    nms_mask,
)
from sos_wsod_torch.tools.bench_nms import SHAPES, bounds, nms_case, pairs_needed, sorted_inputs

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLD = ROOT / "tests" / "goldens"
SRC = (ROOT / "sos_wsod_torch" / "csrc" / "nms.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


TILE = 64


def test_tile_matches_the_source():
    assert _constant("kTile") == kernel.TILE == TILE


def _suppress_bits(b: np.ndarray, thr: float) -> np.ndarray:
    """(S, S) bool, [i, j]: IoU(i, j) > thr and j > i, by the plain
    version's f32 steps: max/min of the corners, (rb - lt) clamped at 0,
    w * h, (area_i + area_j) - inter, the union guard, inter / union."""
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


def _above(inter: np.ndarray, uni: np.ndarray, thr: float) -> np.ndarray:
    """The mask kernel's compare: for inter > 0, inter > m * safe in f64
    (>= where the midpoint's tie rounds up), else 0 > t."""
    m, tie_up, zero_suppresses = kernel.threshold_constants(thr)
    safe = np.where(uni > 0, uni, np.float32(1)).astype(np.float64)
    x = inter.astype(np.float64)
    with np.errstate(invalid="ignore"):
        cmp = x >= m * safe if tie_up else x > m * safe
    return np.where(inter > 0, cmp, zero_suppresses)


def _divide(inter: np.ndarray, uni: np.ndarray, thr: float) -> np.ndarray:
    """The plain version's compare: f32(inter / safe) > f32(thr)."""
    safe = np.where(uni > 0, uni, np.float32(1))
    with np.errstate(invalid="ignore", divide="ignore", over="ignore", under="ignore"):
        iou = np.where(inter > 0, inter / safe, np.float32(0))
    assert iou.dtype == np.float32
    return iou > np.float32(thr)


EMPTY = np.array([np.inf, np.inf, -np.inf, -np.inf], np.float32)


def _kernel_bits(b: np.ndarray, v: np.ndarray, thr: float) -> np.ndarray:
    """(S, S) bool, the mask kernel's bits for every pair of one problem
    (before the diagonal mask): NaN once a box, plain min/max, the
    divide-free compare."""
    nan = np.isnan(b).any(1)
    cols = np.where((v & ~nan)[:, None], b, EMPTY)
    zero_suppresses = kernel.threshold_constants(thr)[2]
    with np.errstate(invalid="ignore", over="ignore"):
        area = (cols[:, 2] - cols[:, 0]) * (cols[:, 3] - cols[:, 1])
        row_area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        w = np.fmax(np.minimum(b[:, None, 2], cols[None, :, 2])
                    - np.maximum(b[:, None, 0], cols[None, :, 0]), np.float32(0))
        h = np.fmax(np.minimum(b[:, None, 3], cols[None, :, 3])
                    - np.maximum(b[:, None, 1], cols[None, :, 1]), np.float32(0))
        inter = w * h
        uni = (row_area[:, None] + area[None, :]) - inter
    assert inter.dtype == uni.dtype == np.float32
    bits = _above(inter, uni, thr)
    bits[nan | ~v] = zero_suppresses
    return bits


def _mask_words(b: np.ndarray, v: np.ndarray, thr: float, rng) -> np.ndarray:
    """The mask kernel's output: (S, W) uint64, bit t of word w of row i =
    box i suppresses box 64 w + t; garbage in the words below the diagonal
    and in the tiles with no valid row or no valid column."""
    s = b.shape[0]
    words = -(-s // TILE)
    bits = np.zeros((s, words * TILE), bool)
    bits[:, :s] = _kernel_bits(b, v, thr) & np.triu(np.ones((s, s), bool), 1)
    weights = np.uint64(1) << np.arange(TILE, dtype=np.uint64)
    packed = (bits.reshape(s, words, TILE).astype(np.uint64) * weights).sum(-1, dtype=np.uint64)
    tile_valid = np.zeros(words * TILE, bool)
    tile_valid[:s] = v
    tile_valid = tile_valid.reshape(words, TILE).any(1)
    row_word = np.arange(s) // TILE
    written = ((np.arange(words)[None, :] >= row_word[:, None]) & tile_valid[row_word][:, None]
               & tile_valid[None, :])
    garbage = rng.integers(0, 2**63, packed.shape, dtype=np.int64).astype(np.uint64)
    return np.where(written, packed, garbage)


def _sweep(mask: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The sweep kernel's walk over one problem, step by step."""
    s, words = mask.shape
    keep = np.zeros(s, bool)              # the flags after the last valid word
    if not valid.any():
        return keep
    last = int(np.nonzero(valid)[0][-1]) // TILE
    removed = [0] * words
    carry, kept = 0, []                   # kept: step i - 1's kept rows
    row = lambda r, w: int(mask[r, w]) if r < s else 0   # noqa: E731
    for i in range(last + 1):
        # warp 0: decide word i, then the kept rows' word i + 1 into the carry
        live = sum(1 << t for t in range(TILE) if i * TILE + t < s and valid[i * TILE + t])
        cand = live & ~(removed[i] | carry)
        kw, before = cand, None
        while kw != before:               # the fixpoint over the word's rows
            before, sup = kw, 0
            for t in range(TILE):
                if (kw >> t) & 1:
                    sup |= row(i * TILE + t, i)
            kw = cand & ~sup
        for t in range(TILE):
            if i * TILE + t < s:
                keep[i * TILE + t] = bool((kw >> t) & 1)
        new_carry = 0
        for t in range(TILE):
            if (kw >> t) & 1 and i + 1 <= last:
                new_carry |= row(i * TILE + t, i + 1)
        # workers: step i - 1's kept rows into words i + 1 .. last
        for t in kept:
            for w in range(i + 1, last + 1):
                removed[w] |= row((i - 1) * TILE + t, w)
        carry = new_carry
        kept = [t for t in range(TILE) if (kw >> t) & 1]   # the list in shared memory
    return keep


def _emulated_keep_sorted(b: np.ndarray, v: np.ndarray, thr: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_sweep(_mask_words(b[i], v[i], thr, rng), v[i]) for i in range(b.shape[0])])


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


def _near_midpoint(thr: float, rng, n: int = 20000):
    """(inter, uni) f32 pairs at, one ulp above and one ulp below the
    rounding midpoint of thr (inter the f32 nearest m * uni and its
    neighbours), over unions from subnormal to large, and the union guard:
    uni of 0, -0, negative and NaN, which divide by 1."""
    m = kernel.threshold_constants(thr)[0]
    uni = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-140, 100, n)).astype(np.float32)
    mid = (m * uni.astype(np.float64)).astype(np.float32)
    inter = np.concatenate([mid, np.nextafter(mid, np.float32(np.inf)),
                            np.nextafter(mid, np.float32(0)), np.nextafter(np.nextafter(
                                mid, np.float32(np.inf)), np.float32(np.inf))])
    uni = np.tile(uni, 4)
    guard_inter = np.float32(m) * np.float32([1, 1, 1, 1, 1])
    guard = np.concatenate([guard_inter, np.nextafter(guard_inter, np.float32(np.inf)),
                            np.nextafter(guard_inter, np.float32(0))])
    guard_uni = np.tile(np.float32([0, -0.0, -3, np.nan, -np.inf]), 3)
    return np.concatenate([inter, guard]), np.concatenate([uni, guard_uni])


@pytest.mark.parametrize("thr", [0.01, 0.3, 0.5, 0.7])
def test_exact_compare_matches_the_f32_divide(thr):
    """inter > m * safe in f64 gives the bit of f32(inter / safe) > f32(thr)
    at, one ulp above and one ulp below the rounding midpoint, under the
    union guard, and for pairs of boxes with NaN and infinite coordinates."""
    inter, uni = _near_midpoint(thr, np.random.default_rng(int(thr * 100)))
    want = _divide(inter, uni, thr)
    np.testing.assert_array_equal(_above(inter, uni, thr), want)
    assert 0 < want.sum() < want.size              # both sides of the threshold
    rng = np.random.default_rng(1)
    b = rng.uniform(0, 50, (300, 4)).astype(np.float32)
    b[:, 2:] += b[:, :2] * rng.uniform(0.5, 1.5, (300, 2)).astype(np.float32)
    flat = b.reshape(-1)
    for val in (np.nan, np.inf, -np.inf):
        flat[rng.integers(0, flat.size, 40)] = val
    s = b.shape[0]
    got = _kernel_bits(b, np.ones(s, bool), thr) & np.triu(np.ones((s, s), bool), 1)
    np.testing.assert_array_equal(got, _suppress_bits(b, thr))
    plain = (pairwise_iou(torch.from_numpy(b), torch.from_numpy(b)) > thr).numpy()
    np.testing.assert_array_equal(got, plain & np.triu(np.ones((s, s), bool), 1))
    assert got.any()


TINY = 2.0 ** -149      # the least f32


@pytest.mark.parametrize("t_units,inter_units,u_even", [
    (0, 1, False), (1, 3, True), (5, 11, True), (6, 13, False), (2, 5, False), (3, 7, True)])
def test_exact_compare_at_a_midpoint_tie(t_units, inter_units, u_even):
    """A pair exactly at the midpoint m = (t + u) / 2, which only subnormal
    thresholds reach: inter = (2 t + 1) ulps, safe = 2. The f32 divide rounds
    the tie to the even significand, so it is above t exactly when u's
    significand is even; the compare's tie flag says the same."""
    thr = t_units * TINY
    m, tie_up, _ = kernel.threshold_constants(thr)
    inter, uni = np.float32([inter_units * TINY]), np.float32([2])
    assert m * 2 == inter_units * TINY and tie_up == u_even
    assert _divide(inter, uni, thr)[0] == u_even
    np.testing.assert_array_equal(_above(inter, uni, thr), _divide(inter, uni, thr))


@pytest.mark.parametrize("thr", [-0.5, -0.0, 0.0, 1e-45, 0.3, 1.0, 3.4028234663852886e38,
                                 float("inf"), float("-inf"), float("nan")])
def test_threshold_constants(thr):
    """m lies strictly between t and the next f32 u, on no f32 (so no pair
    of f32 lands on both sides' rounding wrongly), and 0 suppresses exactly
    when 0 > t; at the ends nothing or everything is above."""
    m, tie_up, zero_suppresses = kernel.threshold_constants(thr)
    t = np.float32(thr)
    assert zero_suppresses == bool(np.float32(0) > t)
    if np.isnan(t) or t == np.inf:
        assert not tie_up and (np.isnan(m) or m == np.inf)
        return
    with np.errstate(over="ignore"):
        u = np.nextafter(t, np.float32(np.inf))
    assert float(t) < m < (2.0 ** 128 if u == np.inf else float(u))
    inter = np.float32([1e-30, 0.25, 0.5, 0.9999, 1, 7, 3e38])
    uni = np.float32([1, 1, 0.5, 1, 1.0000001, 9, 3.1e38])
    np.testing.assert_array_equal(_above(inter, uni, thr), _divide(inter, uni, thr))


SPARSE = [("mining: 40% of the slots valid", 1, 1024, 0.01, 0.4),
          ("box head: few valid", 3, 1000, 0.5, 0.1), ("one valid box", 2, 300, 0.3, 0.004)]


@pytest.mark.parametrize("name,batch,s,thr,frac", SPARSE)
def test_emulated_kernels_skip_padding_tiles(name, batch, s, thr, frac):
    """Mostly padding, as mining's 1024 seed slots are: the tiles without a
    valid row or column are left unwritten (garbage) and the sweep stops at
    the last valid word, yet the keep mask equals the plain fixpoint's."""
    boxes, scores, valid = nms_case(batch, s, thr, seed=s)
    valid &= np.random.default_rng(s).uniform(0, 1, valid.shape) < frac
    valid[:, 0] = True
    b, v = sorted_inputs(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid))
    emulated = _emulated_keep_sorted(b.numpy(), v.numpy(), thr)
    np.testing.assert_array_equal(emulated, greedy_keep_sorted_reference(b, v, thr).numpy())
    last = int(np.nonzero(v.numpy()[0])[0][-1]) // TILE
    assert last + 1 < -(-s // TILE)                # words after the last valid one


def test_emulated_kernels_with_scattered_valid_flags():
    """Valid flags out of sorted order (a valid box after whole invalid
    words) and NaN and infinite coordinates, straight into the sorted-order
    keep: the unwritten words mark only invalid boxes."""
    rng = np.random.default_rng(5)
    b = rng.uniform(0, 200, (2, 500, 4)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.uniform(-5, 60, (2, 500, 2)).astype(np.float32)
    flat = b.reshape(-1)
    for val in (np.nan, np.inf, -np.inf):
        flat[rng.integers(0, flat.size, 20)] = val
    v = rng.uniform(0, 1, (2, 500)) < 0.5
    v[:, 128:320] = False
    for thr in (-0.5, 0.0, 0.3, 0.7):
        want = greedy_keep_sorted_reference(torch.from_numpy(b), torch.from_numpy(v), thr).numpy()
        np.testing.assert_array_equal(_emulated_keep_sorted(b, v, thr), want)


def test_bounds_and_pairs():
    """Each kept box against every later kept box, and one test for each
    suppressed valid box; the operations bind at the real shapes, and the
    mask words' time stays beside the bound."""
    keep = torch.tensor([[True, False, False, True, True], [False, True, False, False, True]])
    valid = torch.tensor([[True, True, False, True, True], [True, True, False, True, True]])
    assert pairs_needed(keep, valid) == (3 + 1) + (1 + 2)
    r = bounds(20, 4096, 10 ** 8)
    assert r["bound_by"] == "operations"
    assert r["ops_bound_ms"] == pytest.approx(10 ** 8 * kernel.OPS_PER_PAIR / 67e12 * 1e3)
    assert r["bytes_bound_ms"] == pytest.approx(20 * 4096 * 18 / 3.35e12 * 1e3)
    assert r["mask_words_ms"] == pytest.approx(kernel.traffic_bytes(20, 4096) / 3.35e12 * 1e3)
    assert bounds(20, 4096, 0)["bound_by"] == "bytes"


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
        kernel.nms_mask_words_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.nms_sweep_cuda(torch.zeros(1, 4, 1, dtype=torch.int64),
                              torch.ones(1, 4, dtype=torch.bool))


def test_traffic_bytes():
    """Boxes, valid flags, the mask words on and above the diagonal written
    and read once, the keep flags: 64 W (W + 1) / 2 words a problem."""
    assert kernel.traffic_bytes(1, 64) == 16 * 64 + 64 + 2 * 8 * 64 + 64
    assert kernel.traffic_bytes(20, 4096) == 20 * (18 * 4096 + 16 * 64 * 64 * 65 // 2)
