"""The port's entry points (sos_wsod_torch/entry.py) against the
repository's JAX ones (__graft_entry__.py), on the CPU:

  - ``_tiny_image_batch`` draws the JAX one's arrays from the same
    RandomState, bit for bit;
  - ``entry(device="cpu")``: the same batch as the JAX ``entry()``, and its
    ``fn`` on the JAX entry's own weights (``state_dict_from_flax``) gives
    the JAX ``fn``'s outputs: the flagship OICR+ model at full width in f32,
    all_scores within rtol 1e-4 / atol 1e-6, all_boxes within 1e-3 px, the
    100 detections the same boxes (1e-3 px) and scores (rtol 1e-4), each
    held against the JAX set by its nearest box; its own seeded model gives
    finite outputs of the JAX shapes.
"""
from __future__ import annotations

import functools

import flax.linen
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_torch import entry as port_entry
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN


def test_tiny_image_batch_draws_the_jax_arrays():
    kw = dict(p=32, h1=48, w1=64, h2=64, w2=80)
    want = jax_entry._tiny_image_batch(np.random.RandomState(3), **kw)
    got = port_entry._tiny_image_batch(np.random.RandomState(3), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k


def _jit_init(self, rngs, *args, **kwargs):
    """flax's ``Module.init`` under one ``jax.jit``: the JAX entry's eager
    init compiles op by op, ~23 s here against ~6 s."""
    return jax.jit(functools.partial(flax.linen.Module.init, self, **kwargs))(rngs, *args)


def test_entry_on_the_jax_weights_gives_the_jax_outputs(monkeypatch):
    monkeypatch.setattr(JaxMultiInputRCNN, "init", _jit_init)
    jfn, (params, jbatch) = jax_entry.entry()
    want = [np.asarray(x) for x in jax.jit(jfn)(params, jbatch)]
    fn, (model, batch) = port_entry.entry(device="cpu")
    assert sorted(batch) == sorted(jbatch)
    for k in jbatch:
        assert np.array_equal(batch[k].numpy(), np.asarray(jbatch[k])), k
    own = [o.numpy() for o in fn(model, batch)]
    assert [o.shape for o in own] == [w.shape for w in want]
    assert all(np.isfinite(o).all() for o in own)
    del model, own

    twin = load_weights(MultiInputRCNN(num_classes=20, seed_cap=128, detections_per_image=100,
                                       device="meta"), state_dict_from_flax(params), "cpu")
    scores, boxes, det_boxes, det_scores = (o.numpy() for o in fn(twin, batch))
    np.testing.assert_allclose(scores, want[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(boxes, want[1], rtol=0, atol=1e-3)
    assert det_boxes.shape == want[2].shape
    for b, s in zip(det_boxes, det_scores):
        i = int(np.abs(want[2] - b).max(1).argmin())
        np.testing.assert_allclose(b, want[2][i], rtol=0, atol=1e-3)
        np.testing.assert_allclose(s, want[3][i], rtol=1e-4, atol=1e-7)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
