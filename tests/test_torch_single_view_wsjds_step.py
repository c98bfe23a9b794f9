"""One training step of the port's single-view model with the WSJDS head
against the JAX train step, before and past WSL.CSC_MAX_ITER, then predict
with its masks; and the WSJDS head on WS-ResNet with the ROIAlignV2 pooler.
On the CPU in float32, at the sizes and with the fixtures of
tests/test_torch_single_view_wsjds.py (ASPP 8/8, dropout off on both sides):
  - one step of 1 image through the port's Stage1Trainer and the JAX
    Stage1Trainer (``make_stage1_train_step`` with inject_iter and
    inject_cpgs), each computing its own CPG maps (csc_tau 0); past
    CSC_MAX_ITER loss_sem_seg is 0, the ASPP gets zero gradients (SGD's
    weight decay and momentum still move its weights) and the mask_ terms
    remain, 0.1 x the plain MIL terms;
  - WS-ResNet-14 (res5's 2048 channels into the ASPP) with ROIAlignV2: the
    loss terms on random CPG-like maps. Its random features reach |x| ~ 350,
    the ASPP's logits +-100, and a peak-normalised mask cell lies within
    1e-4 of the CSC op's 0.1 threshold, where two f32 implementations may
    binarise it apart: the gradients of that model are not compared (the
    VGG16 model's are, in the other file).
Tolerances: losses within rtol 1e-4 / atol 1e-5, parameters after the step
within rtol 1e-5 / atol 1e-7, scores and masks within rtol 1e-4 / atol 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.engine.trainer import Stage1Trainer as JaxStage1Trainer
from sos_wsod_torch.engine.trainer import Stage1Trainer
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL
from test_torch_single_view import (  # noqa: F401 (fixtures)
    ITER, NUM_CLASSES, P, _flax_grad, _jax_batch, _leaf, _sample, _torch_batch, no_jax_dropout,
    one_thread)
from test_torch_single_view_csc import _cfgs, _init
from test_torch_single_view_wsjds import (  # noqa: F401 (fixtures)
    CANVAS, _pair, _with_cpgs, jax_rcnn, small_aspp_no_dropout)


@pytest.mark.parametrize("past", [False, True])
def test_wsjds_step_matches_the_jax_train_step(past):
    """One step of 1 image through each package's Stage1Trainer (each
    computes its own CPG maps); ``past``: at iteration 1 with
    WSL.CSC_MAX_ITER 0. The logged losses, every parameter after the update
    (SGD with momentum, weight decay 5e-4 and the bias LR factor), the
    ASPP's momentum buffers (past: its gradient was zeros, so the buffer is
    the weight decay's term alone), then predict with the masks."""
    opts = ["MODEL.ROI_HEADS.NAME", "WSJDSROIHeads", "MODEL.BACKBONE.FREEZE_AT", "0",
            "WSL.CSC_MAX_ITER", "0" if past else "35000"]
    cfg, jcfg = _cfgs(*opts)
    start = int(past)
    sample = _sample(4)
    jm = jax_rcnn.GeneralizedRCNNWSL.from_cfg(jcfg, csc_tau=0.0, dtype=jnp.float32)
    params = _init(jm, _with_cpgs(sample))
    jt = JaxStage1Trainer(jcfg, model=jm, data_iter=iter([[sample]]))
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state = {"params": tree, "opt_state": jt.tx.init(tree),
                "iter": jnp.asarray(start, jnp.int32)}
    jt.train(start, start + 1)

    tm = load_weights(GeneralizedRCNNWSL.from_cfg(cfg, device="meta", csc_tau=0.0,
                                                  dan_dropout=0.0),
                      state_dict_from_flax(params, dan_channels_last=False), "cpu")
    tt = Stage1Trainer(cfg, tm, iter([[sample]]))
    tt.train(start, start + 1)
    want = {k: h.latest for k, h in jt.storage.histories().items() if k != "data_time"}
    got = {k: h.latest for k, h in tt.storage.histories().items() if k != "data_time"}
    assert set(got) == set(want) == {"loss_cls_pos", "loss_cls_neg", "loss_sem_seg",
                                     "mask_loss_cls_pos", "mask_loss_cls_neg", "total_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    if past:
        assert got["loss_sem_seg"] == want["loss_sem_seg"] == 0.0
        np.testing.assert_allclose(got["mask_loss_cls_pos"], 0.1 * got["loss_cls_pos"],
                                   rtol=1e-6)
    else:
        assert got["loss_sem_seg"] > 0
    stepped = jax.tree_util.tree_map(np.asarray, jt.state["params"])
    wd = cfg.SOLVER.WEIGHT_DECAY
    for name, p in tm.named_parameters():
        w = _leaf(stepped, name)
        np.testing.assert_allclose(_flax_grad(name, p.detach()), w, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        moved = np.abs(w - _leaf(params, name)).max()
        aspp = name.startswith("roi_heads.sem_seg_head.")
        if aspp:
            buf = tt.optimizer.state[p]["momentum_buffer"]    # SGD skips a None gradient
            if past and name.endswith(".weight"):
                w0 = torch.from_numpy(np.ascontiguousarray(_leaf(params, name)))
                np.testing.assert_allclose(buf.numpy(), (w0.permute(3, 2, 0, 1) * wd).numpy(),
                                           rtol=1e-6, atol=1e-12, err_msg=name)
        # ASPP biases start at zero and take no weight decay: past CSC_MAX_ITER they stay
        assert moved > 0 or name.endswith("det.bias") or (past and aspp and "bias" in name), name

    out_j = jm.apply({"params": jt.state["params"]}, _jax_batch(sample), False)
    with torch.no_grad():
        det, scores, boxes, masks = tm.eval().predict(_torch_batch(sample))
    assert len(out_j) == 4
    np.testing.assert_allclose(scores.numpy(), np.asarray(out_j[1]), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(out_j[2]))
    assert masks.shape == (NUM_CLASSES,) + CANVAS and masks.dtype == torch.float32
    np.testing.assert_allclose(masks.numpy(), np.asarray(out_j[3]), rtol=1e-4, atol=1e-6)
    assert scores.shape == (P, NUM_CLASSES + 1) and det.valid.any()


def test_wsjds_on_ws_resnet_with_roialign_v2_matches_jax():
    """WS-ResNet-14 (res5 2048 channels into the ASPP, the stem and res2
    frozen) with the ROIAlignV2 pooler: the five loss terms on random
    CPG-like maps against the JAX model's eager apply."""
    sample = _sample(5)
    kw = dict(backbone_name="ws_resnet", resnet_depth=14, pooler_type="ROIAlignV2", freeze_at=2)
    jm, params, tm = _pair(sample, **kw)
    assert tm.roi_heads.sem_seg_head.dilation6.conv1.in_channels == 2048
    cpgs = (np.random.RandomState(5).uniform(0, 1, (NUM_CLASSES,) + CANVAS) ** 3
            ).astype(np.float32)
    want = jm.apply({"params": params}, {**_jax_batch(sample), "cpgs": jnp.asarray(cpgs)}, True)
    with torch.no_grad():
        got = tm.loss(_torch_batch(sample), cur_iter=ITER, cpgs=torch.from_numpy(cpgs))
    assert set(got) == set(want) and len(got) == 5
    for k in sorted(want):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(got["loss_sem_seg"]) > 0
