"""The port's single-view model (GeneralizedRCNNWSL) with the CSC head, the
WS-ResNet backbone and the ROIAlign / ROIAlignV2 poolers against the JAX
package's, on the CPU in float32, at the sizes of
tests/test_torch_single_view.py (a 48 x 64 canvas, DAN 32/32, 3 classes, 24
proposal slots with 20 valid):
  - CSC on VGG16: the CPG maps of ``compute_cpgs`` against the JAX model's
    (csc_tau 0, so that every present class has its map; freeze_at 0, see
    below), then the loss and every gradient on the same maps; one training
    step of the port's Stage1Trainer against the JAX train step itself
    (``make_stage1_train_step`` with inject_iter and inject_cpgs, through
    the JAX Stage1Trainer), each side computing its own maps; then predict;
  - the CPG maps with the config's freeze_at 2: the port's gradient reaches
    the image through the frozen stages, as in the reference, and equals
    the JAX maps with nothing frozen; the JAX model's stop_gradient leaves
    its maps at 2 all zero (the departure ROADMAP Queue 3 records);
  - WS-ResNet and the ROIAlign poolers: tests/test_torch_single_view_ws.py.
Dropout is off on both sides. Tolerances are those of
tests/test_torch_single_view.py: loss terms within rtol 1e-4 / atol 1e-5;
gradients within rtol 1e-4 and 1e-5 of the leaf's largest entry (plus
1e-8); scores within rtol 1e-4 / atol 1e-6. The CPG maps (normalised to a
peak of 1, after a backward through 13 convolutions) within rtol 1e-4 /
atol 1e-5; a cell whose two maps fall on either side of the CSC op's 0.1
threshold flips a bit of its binary map, and is reported by count and value
(each must lie within that tolerance of 0.1). Parameters after the step
within rtol 1e-5 / atol 1e-7.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.engine.trainer import Stage1Trainer as JaxStage1Trainer
from sos_wsod_tpu.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL as JaxGeneralizedRCNNWSL
from sos_wsod_torch.engine.synthetic import load_config
from sos_wsod_torch.engine.trainer import Stage1Trainer
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL
from test_torch_single_view import (  # noqa: F401 (fixtures)
    ITER, KW, NUM_CLASSES, P, _flax_grad, _jax_batch, _leaf, _sample, _torch_batch,
    no_jax_dropout, one_thread)

CONFIG = str(pathlib.Path(__file__).resolve().parents[1] / "configs" / "stage1" /
             "voc07_oicr_plus.yaml")
NORM_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _init(jm, sample, method=None):
    """The JAX model's own init, with random conv biases (VGG16) or random
    FrozenBN statistics (WS-ResNet), and the refinement branches' logits
    spread so that mining ranks are not near-ties."""
    batch = _jax_batch(sample)
    kw = {"method": jm.forward_scores} if method == "scores" else {}
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)}, batch, True,
                                    **kw)["params"])
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.RandomState(0)
    for stage in params["backbone"].values():
        for name, layer in stage.items():
            if "bias" in layer and "kernel" in layer:                 # a VGG16 conv
                layer["bias"] = rng.normal(0, 0.05, layer["bias"].shape).astype(np.float32)
            elif "running_var" in layer:                              # a FrozenBN
                c = layer["weight"].shape
                layer.update(weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
                             bias=rng.normal(0, 0.2, c).astype(np.float32),
                             running_mean=rng.normal(0, 0.2, c).astype(np.float32),
                             running_var=rng.uniform(0.5, 1.5, c).astype(np.float32))
    for name, sub in params["roi_heads"].items():
        if name.startswith("box_refinery"):
            for leaf in sub.values():
                leaf["kernel"] = leaf["kernel"] * 30.0
    return params


def _port(params, **kw):
    tm = GeneralizedRCNNWSL(dan_dropout=0.0, device="meta", **{**KW, **kw})
    return load_weights(tm, state_dict_from_flax(params, dan_channels_last=False), "cpu").train()


def _check_loss_and_grads(jm, params, tm, sample, cpgs=None):
    """Loss terms and every gradient leaf of one image: the JAX model's
    eager ``model.apply`` under ``jax.value_and_grad`` against the port's
    ``loss`` and backward; with ``cpgs`` (numpy) both take those maps."""
    batch = _jax_batch(sample) if cpgs is None else {**_jax_batch(sample),
                                                      "cpgs": jnp.asarray(cpgs)}

    def total(p):
        losses = jm.apply({"params": p}, batch, True)
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, want), grads = jax.value_and_grad(total, has_aux=True)(params)
    kw = {} if cpgs is None else {"cpgs": torch.tensor(cpgs)}
    losses = tm.loss(_torch_batch(sample), cur_iter=ITER, **kw)
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    assert set(losses) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    named = dict(tm.named_parameters())
    n_leaves = 0
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        keys = [str(k.key) for k in path]
        g = np.asarray(g)
        if keys[-1] in NORM_LEAVES and "_norm" in keys[-2]:      # FrozenBN: buffers here
            assert not g.any(), keys
            continue
        n_leaves += 1
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else "bias"])
        p = named[name]
        if not p.requires_grad:
            assert p.grad is None and not g.any(), name
            continue
        np.testing.assert_allclose(_flax_grad(name, p.grad), g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=name)
    assert n_leaves == len(named)
    return want


def _cpg_maps_close(got: np.ndarray, want: np.ndarray) -> str:
    """The maps within rtol 1e-4 / atol 1e-5; each cell the two maps
    binarise differently at 0.1 must lie within that tolerance of it.
    Returns a report of those cells."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    flips = (got >= 0.1) != (want >= 0.1)
    assert (np.abs(want[flips] - 0.1) <= 1e-5 + 1e-4 * 0.1).all()
    return f"{int(flips.sum())} cells straddle 0.1: {want[flips].tolist()}"


def _csc_pair(sample, freeze_at=0):
    jm = JaxGeneralizedRCNNWSL(head="CSC", pooler_type="ROIPool", dtype=jnp.float32, csc_tau=0.0,
                               freeze_at=freeze_at, **KW)
    params = _init(jm, sample, method="scores")
    tm = _port(params, head="CSC", csc_tau=0.0, freeze_at=freeze_at)
    return jm, params, tm


def test_csc_cpg_maps_loss_and_gradients_match_jax():
    """csc_tau 0: the present classes 0 and 2 get their maps, class 1 none;
    then the loss (iter 20, the constraints on) and every gradient on the
    JAX maps. The cells that straddle the threshold are printed (none at
    this seed)."""
    sample = _sample(3)
    jm, params, tm = _csc_pair(sample)
    want = np.asarray(jm.compute_cpgs({"params": params}, _jax_batch(sample)))
    got = tm.compute_cpgs(_torch_batch(sample)).numpy()
    assert got.shape == (NUM_CLASSES, 48, 64) and not got[1].any() and not want[1].any()
    assert got[[0, 2]].max() == 1.0 and (got[[0, 2]] > 0).mean() > 0.5
    print(_cpg_maps_close(got, want))
    assert all(p.grad is None for p in tm.parameters())     # the maps touch no gradient
    _check_loss_and_grads(jm, params, tm, sample, want)


def test_csc_cpg_through_frozen_stages():
    """With freeze_at 2 the port's maps equal the JAX maps with freeze_at 0
    (the same forward: freezing changes no value), where the JAX model's own
    are zero; plain1 and plain2 still take no parameter gradient."""
    sample = _sample(3)
    jm0, params, _ = _csc_pair(sample, freeze_at=0)
    jm2 = JaxGeneralizedRCNNWSL(head="CSC", pooler_type="ROIPool", dtype=jnp.float32,
                                csc_tau=0.0, freeze_at=2, **KW)
    tm = _port(params, head="CSC", csc_tau=0.0, freeze_at=2)
    want = np.asarray(jm0.compute_cpgs({"params": params}, _jax_batch(sample)))
    frozen = np.asarray(jm2.compute_cpgs({"params": params}, _jax_batch(sample)))
    got = tm.compute_cpgs(_torch_batch(sample)).numpy()
    assert not frozen.any() and want.any()
    _cpg_maps_close(got, want)
    assert not any(p.requires_grad for p in tm.backbone.plain1.parameters())


def _cfgs(*opts):
    opts = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL", "MODEL.ROI_HEADS.NUM_CLASSES",
            str(NUM_CLASSES), "MODEL.ROI_BOX_HEAD.DAN_DIM", "[32, 32]", "TPU.COMPUTE_DTYPE",
            "float32", "SOLVER.IMS_PER_BATCH", "1", "TEST.DETECTIONS_PER_IMAGE", "10",
            "WSL.REFINE_NUM", "3", "WSL.REFINE_REG", "[False, False, False]", *opts]
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(CONFIG)
    jcfg.merge_from_list(list(opts))
    return load_config(CONFIG, [*opts, "MODEL.DEVICE", "cpu"]), jcfg


def test_csc_step_matches_the_jax_train_step():
    """One step of 1 image: the port's Stage1Trainer (CPG maps from the
    bare module in the ``cpg`` range, the generator's state restored
    before the loss) against the JAX Stage1Trainer, whose jitted step
    injects the step and each image's CPG maps; each side computes its own
    maps. The logged losses, every parameter after the update (SGD with
    momentum, weight decay and the bias LR factor), then predict."""
    cfg, jcfg = _cfgs("MODEL.ROI_HEADS.NAME", "CSCROIHeads", "MODEL.BACKBONE.FREEZE_AT", "0")
    sample = _sample(4)
    jm = JaxGeneralizedRCNNWSL.from_cfg(jcfg, csc_tau=0.0, dtype=jnp.float32)
    params = _init(jm, sample, method="scores")
    jt = JaxStage1Trainer(jcfg, model=jm, data_iter=iter([[sample]]))
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state = {"params": tree, "opt_state": jt.tx.init(tree), "iter": jnp.zeros((), jnp.int32)}
    jt.train(0, 1)

    tm = load_weights(GeneralizedRCNNWSL.from_cfg(cfg, device="meta", csc_tau=0.0,
                                                  dan_dropout=0.0),
                      state_dict_from_flax(params, dan_channels_last=False), "cpu")
    tt = Stage1Trainer(cfg, tm, iter([[sample]]))
    seen = []
    cpgs = tm.compute_cpgs
    tm.compute_cpgs = lambda *a: seen.append(tt.generator.get_state()) or cpgs(*a)
    tt.train(0, 1)
    assert len(seen) == 1 and tt.iter == jt.iter == 1
    want = {k: h.latest for k, h in jt.storage.histories().items() if k != "data_time"}
    got = {k: h.latest for k, h in tt.storage.histories().items() if k != "data_time"}
    assert set(got) == set(want) == {"loss_cls_pos", "loss_cls_neg", "total_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    stepped = jax.tree_util.tree_map(np.asarray, jt.state["params"])
    for name, p in tm.named_parameters():
        w = _leaf(stepped, name)
        np.testing.assert_allclose(_flax_grad(name, p.detach()), w, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        moved = np.abs(w - _leaf(params, name)).max()
        assert moved > 0 or name.endswith("det.bias"), name

    _, scores_j, boxes_j = jm.apply({"params": jt.state["params"]}, _jax_batch(sample), False)
    with torch.no_grad():
        det, scores, boxes = tm.eval().predict(_torch_batch(sample))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(boxes_j))
    assert scores.shape == (P, NUM_CLASSES + 1) and det.valid.any()
