"""The port's ROILabel (sos_wsod_torch/ops/roi_label.py) against the JAX
package's (sos_wsod_tpu/ops/roi_label.py) and the reference golden
tests/goldens/roi_label.npz, on the CPU; and d2-WSL's signed overlap
(core/boxes.py:pairwise_iou_wsl) against the JAX package's, within one f32
ulp.

The port draws its permutation from ``core/sampling.py:permutation``; the
tests stand in JAX's ``jax.random.permutation`` of the same key, so both
apply the caps in the same order. RL must be equal, RW within 1e-6 (one
f32 gather of the same values; the tolerance is the golden test's).
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.core.boxes import pairwise_iou_wsl as jax_pairwise_iou_wsl
from sos_wsod_tpu.ops.roi_label import roi_label as jax_roi_label
from sos_wsod_torch.core import sampling
from sos_wsod_torch.core.boxes import pairwise_iou, pairwise_iou_wsl
from sos_wsod_torch.ops.roi_label import roi_label

GOLD = pathlib.Path(__file__).resolve().parent / "goldens" / "roi_label.npz"


def _jax_permutation(key):
    def draw(n, generator, device):
        return torch.from_numpy(np.asarray(jax.random.permutation(key, n)).astype(np.int64))
    return draw


def _case(seed, r=40, c=6, pad=6):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (r, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (r, 2))], 1).astype(np.float32)
    boxes[: r // 3] = boxes[r // 3: 2 * (r // 3)] + rng.normal(0, 2, (r // 3, 4)).astype(np.float32)
    iou = pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    scores = rng.uniform(0, 1, (r, c + 1)).astype(np.float32)
    scores[5, 0] = scores[7, 0] = scores[:, 0].max() + 0.5     # a tie for class 0's seed
    labels = (rng.uniform(0, 1, c) > 0.4).astype(np.float32)
    labels[0] = 1.0
    valid = np.arange(r) < r - pad
    cw = rng.uniform(0.1, 1, c).astype(np.float32)
    return scores, iou, labels, valid, cw


def _both(monkeypatch, key, scores, iou, labels, valid, cw, **kw):
    want = jax_roi_label(jnp.asarray(scores), jnp.asarray(iou), jnp.asarray(labels),
                         jnp.asarray(valid), key,
                         None if cw is None else jnp.asarray(cw), **kw)
    monkeypatch.setattr(sampling, "permutation", _jax_permutation(key))
    got = roi_label(torch.from_numpy(scores), torch.from_numpy(iou), torch.from_numpy(labels),
                    torch.from_numpy(valid), torch.Generator(),
                    None if cw is None else torch.from_numpy(cw), **kw)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


KW = [dict(top_k=1, num_pos=2, num_neg=3, bg_thresh_lo=0.05),
      dict(top_k=2, num_pos=32, num_neg=96),
      dict(top_k=3, num_pos=0, num_neg=1, fg_thresh=0.6, bg_thresh_hi=0.4, bg_thresh_lo=0.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", KW, ids=["k1-capped", "k2", "k3-bands"])
@pytest.mark.parametrize("weights", [True, False], ids=["cw", "seed-scores"])
def test_roi_label_matches_jax(monkeypatch, seed, kw, weights):
    scores, iou, labels, valid, cw = _case(seed)
    (rl, rw), (want_rl, want_rw) = _both(monkeypatch, jax.random.PRNGKey(seed), scores, iou,
                                         labels, valid, cw if weights else None, **kw)
    assert rl.dtype == np.int32 and rw.dtype == np.float32
    np.testing.assert_array_equal(rl, want_rl)
    np.testing.assert_allclose(rw, want_rw, rtol=1e-6, atol=1e-6)
    assert (rw > 0).any() and (rl == len(labels)).any()      # foreground and background
    assert not rw[~valid].any()


def test_roi_label_no_present_class(monkeypatch):
    scores, iou, labels, valid, cw = _case(4)
    (rl, rw), (want_rl, want_rw) = _both(monkeypatch, jax.random.PRNGKey(0), scores, iou,
                                         np.zeros_like(labels), valid, cw)
    np.testing.assert_array_equal(rl, want_rl)
    np.testing.assert_allclose(rw, want_rw, rtol=1e-6, atol=1e-6)
    assert not rw.any()


def test_roi_label_matches_reference_golden(monkeypatch):
    z = np.load(GOLD)
    r = z["S"].shape[0]
    p = z["P"]
    kw = dict(top_k=int(p[5]), fg_thresh=float(p[0]), bg_thresh_hi=float(p[1]),
              bg_thresh_lo=float(p[2]), num_pos=int(p[3]), num_neg=int(p[4]))
    (rl, rw), (want_rl, want_rw) = _both(monkeypatch, jax.random.PRNGKey(0), z["S"], z["U"],
                                         z["L"][0], np.ones(r, bool), z["CW"][0], **kw)
    np.testing.assert_array_equal(rl, z["RL"])
    np.testing.assert_allclose(rw, z["RW"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rl, want_rl)
    # the caps exceed R in the golden, so any permutation gives its answer
    got = roi_label(*(torch.from_numpy(a) for a in (z["S"], z["U"], z["L"][0])),
                    torch.ones(r, dtype=torch.bool), torch.Generator().manual_seed(1),
                    torch.from_numpy(z["CW"][0]), **kw)
    np.testing.assert_array_equal(got[0].numpy(), z["RL"])


def test_roi_label_refuses_overlapping_bands():
    scores, iou, labels, valid, _ = _case(0)
    with pytest.raises(ValueError, match="bg_thresh_hi"):
        roi_label(torch.from_numpy(scores), torch.from_numpy(iou), torch.from_numpy(labels),
                  torch.from_numpy(valid), torch.Generator(), fg_thresh=0.4, bg_thresh_hi=0.5)


def test_pairwise_iou_wsl_matches_jax():
    """Overlapping, disjoint (negative), touching and zero-area pairs, and a
    batch dimension."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (30, 2))
    b1 = np.concatenate([xy, xy + rng.uniform(0, 30, (30, 2))], 1).astype(np.float32)
    b1[:3] = [[0, 0, 0, 0], [5, 5, 5, 9], [10, 10, 20, 20]]
    xy = rng.uniform(0, 50, (20, 2))
    b2 = np.concatenate([xy, xy + rng.uniform(0, 30, (20, 2))], 1).astype(np.float32)
    b2[:2] = [[20, 10, 30, 20], [0, 0, 0, 0]]
    got = pairwise_iou_wsl(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    want = np.asarray(jax_pairwise_iou_wsl(jnp.asarray(b1), jnp.asarray(b2)))
    assert (want < 0).any() and (want > 0).any() and (want == 0).any()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    batched = pairwise_iou_wsl(torch.from_numpy(np.stack([b1, b1])), torch.from_numpy(np.stack([b2, b2])))
    assert torch.equal(batched[1], torch.from_numpy(got))
