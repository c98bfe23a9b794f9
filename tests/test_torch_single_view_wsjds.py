"""The port's single-view model (GeneralizedRCNNWSL) with the WSJDS head
against the JAX package's, on the CPU in float32, at the sizes of
tests/test_torch_single_view.py (a 48 x 64 canvas, DAN 32/32, 3 classes, 24
proposal slots with 20 valid) with the ASPP at 8/8 (both models build their
WSJDS head at the JAX head's 1024/1024: the tests hand them heads of 8/8):
  - VGG16 with ROIPool: the CPG maps of ``compute_cpgs`` (csc_tau 0), then
    the loss and every gradient on the JAX maps; the constraint path (the
    dense CRF on the host) against the JAX model's eager ``model.apply``,
    since its callback cannot run under the JAX train step's vmap;
  - the training step, predict and WS-ResNet with ROIAlignV2:
    tests/test_torch_single_view_wsjds_step.py.
Dropout is off on both sides (the JAX DAN's and the ASPP's flax dropout
replaced by the identity, ``small_aspp_no_dropout``). Tolerances and
helpers are those of tests/test_torch_single_view_csc.py: loss terms within rtol 1e-4 / atol
1e-5, gradients within rtol 1e-4 plus 1e-5 of the leaf's largest entry.
"""
from __future__ import annotations

import functools

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import pytest

from sos_wsod_tpu.models.heads.wsjds import WSJDSROIHead as JaxWSJDSROIHead
from sos_wsod_tpu.models.meta import rcnn_wsl_single as jax_rcnn
from sos_wsod_torch.models.heads.wsjds import WSJDSROIHead
from sos_wsod_torch.models.meta import rcnn_wsl_single as port_rcnn
from test_torch_single_view import (  # noqa: F401 (fixtures)
    KW, NUM_CLASSES, _jax_batch, _sample, _torch_batch, no_jax_dropout, one_thread)
from test_torch_single_view_csc import _check_loss_and_grads, _cpg_maps_close, _init, _port

ASPP = (8, 8)
CANVAS = (48, 64)


@pytest.fixture(autouse=True)
def small_aspp_no_dropout(monkeypatch):
    """Both models' WSJDS heads at ASPP 8/8 (each model builds its head at
    the JAX head's 1024/1024), and their ASPP dropout off: the port's rate
    0, the JAX branches' flax ``nn.Dropout`` the identity."""
    monkeypatch.setattr(jax_rcnn, "WSJDSROIHead", functools.partial(JaxWSJDSROIHead,
                                                                    aspp_dims=ASPP))
    monkeypatch.setattr(flax_nn, "Dropout", lambda rate, deterministic: (lambda x: x))
    monkeypatch.setattr(port_rcnn, "WSJDSROIHead", functools.partial(
        WSJDSROIHead, aspp_dims=ASPP, aspp_dropout=0.0))


def _with_cpgs(sample, cpgs=None):
    return {**sample, "cpgs": np.zeros((NUM_CLASSES,) + CANVAS, np.float32)
            if cpgs is None else cpgs}


def _pair(sample, **kw):
    kw = {"head": "WSJDS", "pooler_type": "ROIPool", "csc_tau": 0.0, "freeze_at": 0, **kw}
    jm = jax_rcnn.GeneralizedRCNNWSL(dtype=jnp.float32, **kw, **KW)
    params = _init(jm, _with_cpgs(sample))
    return jm, params, _port(params, **kw)


def test_wsjds_cpg_maps_loss_and_gradients_match_jax():
    """csc_tau 0: the present classes 0 and 2 get their maps; then the five
    loss terms (iter 20, the constraints on) and every gradient, the ASPP's
    included, on the JAX maps."""
    sample = _sample(3)
    jm, params, tm = _pair(sample)
    assert tm.uses_cpgs and tm.uses_iter
    want = np.asarray(jm.compute_cpgs({"params": params}, _jax_batch(sample)))
    got = tm.compute_cpgs(_torch_batch(sample)).numpy()
    assert got.shape == (NUM_CLASSES,) + CANVAS and not got[1].any()
    print(_cpg_maps_close(got, want))
    losses = _check_loss_and_grads(jm, params, tm, sample, want)
    assert set(losses) == {"loss_cls_pos", "loss_cls_neg", "loss_sem_seg", "mask_loss_cls_pos",
                           "mask_loss_cls_neg"}
    assert float(losses["loss_sem_seg"]) > 0
    assert tm.roi_heads.sem_seg_head.dilation24.conv1.weight.grad.abs().max() > 0


def test_wsjds_constraint_path_matches_jax_eager_apply():
    """wsjds_constraint=True: loss_constraint through the host CRF of the
    sigmoid masks and the raw image, its gradient to the ASPP, against the
    JAX model's eager apply (random CPG-like maps)."""
    sample = _sample(6)
    jm, params, tm = _pair(sample, wsjds_constraint=True)
    cpgs = (np.random.RandomState(6).uniform(0, 1, (NUM_CLASSES,) + CANVAS) ** 3
            ).astype(np.float32)
    losses = _check_loss_and_grads(jm, params, tm, sample, cpgs)
    assert "loss_constraint" in losses and float(losses["loss_constraint"]) > 0
