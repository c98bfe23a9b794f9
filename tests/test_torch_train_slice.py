"""The port's stage-1 training slice against the reference golden and the JAX
package, on the CPU in float32: MultiInputRCNN.loss
(sos_wsod_torch/models/meta/rcnn_wsl.py), its gradients, the weight bridge
and Stage1Trainer (engine/trainer.py).

The JAX loss pools through ``roi_pool_multi``, which splits tied gradients
where the port routes them to the first hit. The only ties in these inputs
are zeros from ReLU and from padding, whose gradient the ReLU and mask
backward zero on both sides, so every parameter gradient agrees.

Tolerances: (d) is the JAX package's own golden bound (rtol 2e-3, atol
2e-5). Elsewhere two f32 implementations whose convolutions and GEMMs sum
in different orders: loss terms within rtol 1e-4 / atol 1e-6; gradients,
which pass back through 13 convolutions, within rtol 1e-3 / atol 1e-5 of the
leaf's largest entry (plus 1e-8 for leaves whose true gradient is 0, such as
the WSDDN det bias under the proposal-axis softmax); parameters after SGD
within rtol 1e-5 / atol 1e-7.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from model_golden_case import H, H2, NUM_CLASSES, W, W2, build_train_case
from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.engine.trainer import Stage1Trainer as JaxStage1Trainer, stack_batch
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.engine.synthetic import build_synthetic_model
from sos_wsod_torch.engine.trainer import Stage1Trainer
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_d2_wsl, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml")
GOLD = ROOT / "tests" / "goldens" / "oicr_plus_train.npz"
DAN = (64, 64)
P = 32


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_loss_matches_reference_train_golden():
    """(d) Every loss term of goldens/oicr_plus_train.npz, recorded from the
    reference's training graph on the weights of tests/model_golden_case.py,
    through the port's loss with seed_cap 64 and dropout 0."""
    z = np.load(GOLD)
    image, image2, boxes4, objectness, gt_oh, blobs = build_train_case()
    model = MultiInputRCNN(num_classes=NUM_CLASSES, seed_cap=64, dan_dropout=0.0, device="meta")
    model = load_weights(model, state_dict_from_d2_wsl(blobs), "cpu").train()
    batch = _torch_batch({
        "images_s1": np.stack([image, image[:, ::-1]]),
        "images_s2": np.stack([image2, image2[:, ::-1]]),
        "valid_hw_s1": np.array([[H, W], [H, W]], np.int32),
        "valid_hw_s2": np.array([[H2, W2], [H2, W2]], np.int32),
        "boxes": boxes4, "objectness": objectness,
        "prop_valid": np.ones(boxes4.shape[1], bool), "gt_classes_oh": gt_oh})
    with torch.no_grad():
        losses = model.loss(batch)
    want = dict(zip(z["loss_names"].tolist(), z["loss_values"].tolist()))
    got = {k: v.item() for k, v in losses.items() if k.startswith("loss")}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-3, atol=2e-5,
                                   err_msg=f"loss term {name}")


def _sample(seed, canvas1=(40, 56), valid1=(36, 50), canvas2=(32, 48), valid2=(30, 40)):
    """One 4-view batch: padded canvases larger than their valid extents,
    P = 32 proposal slots of which 27 are valid, 3 present classes."""
    rng = np.random.RandomState(seed)

    def views(canvas, valid):
        img = np.zeros(canvas + (3,), np.float32)
        img[:valid[0], :valid[1]] = rng.uniform(0, 255, valid + (3,))
        flip = np.zeros_like(img)
        flip[:valid[0], :valid[1]] = img[:valid[0], :valid[1]][:, ::-1]
        return np.stack([img, flip]), np.array([valid, valid], np.int32)

    def boxes(valid):
        h, w = valid
        x1, y1 = rng.uniform(0, w - 16, P), rng.uniform(0, h - 16, P)
        b = np.stack([x1, y1, np.minimum(x1 + rng.uniform(12, w / 2, P), w - 1),
                      np.minimum(y1 + rng.uniform(12, h / 2, P), h - 1)], 1)
        bf = b.copy()
        bf[:, [0, 2]] = w - b[:, [2, 0]]
        return b, bf

    s1, v1 = views(canvas1, valid1)
    s2, v2 = views(canvas2, valid2)
    gt_oh = np.zeros(NUM_CLASSES, np.float32)
    gt_oh[[2, 9, 14]] = 1
    return {"images_s1": s1, "images_s2": s2, "valid_hw_s1": v1, "valid_hw_s2": v2,
            "boxes": np.stack([*boxes(valid1), *boxes(valid2)]).astype(np.float32),
            "objectness": rng.uniform(0, 1, P).astype(np.float32),
            "prop_valid": np.arange(P) < 27, "gt_classes_oh": gt_oh}


def _jax_params(jm, sample):
    """The JAX model's own init(train=True), with the head logits spread so
    mining ranks are not near-ties, and random conv biases: with zero biases
    some ReLU inputs near the padded border sit within f32 rounding of 0,
    where the two frameworks' sums may fall on either side."""
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)},
                                    {k: jnp.asarray(v) for k, v in sample.items()},
                                    train=True)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(0)
    for stage in params["backbone"].values():
        for conv in stage.values():
            conv["bias"] = rng.normal(0, 0.05, conv["bias"].shape).astype(np.float32)
    heads = params["roi_heads"]
    for name in ["wsddn"] + [f"box_refinery_{k}" for k in range(4)]:
        for sub in heads[name].values():
            sub["kernel"] = sub["kernel"] * 30.0
    return params


def _flax_layout(grad: torch.Tensor) -> np.ndarray:
    """A port parameter (or gradient) in the flax layout: OIHW conv weights
    to HWIO, (out, in) Linear weights to (in, out)."""
    a = grad.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a


def _flax_path(name: str):
    *path, leaf = name.split(".")
    return path + ["kernel" if leaf == "weight" else "bias"]


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


VARIANTS = {
    "nms": dict(),
    "nms_bbox_update": dict(bbox_update=True),
    "wetectron": dict(mist_type="wetectron"),
    "top_k": dict(refine_mist=False, refine_reg=(False, True, True, False)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_every_gradient_match_jax(variant):
    """(e) Loss terms, metrics and every parameter's gradient against
    jax.grad of the JAX MultiInputRCNN.loss at DAN (64, 64), P = 32 with
    padded slots and padded canvases, for each mining type and BBOX_UPDATE.
    Frozen stages (plain1, plain2) get no gradient in the port and a zero
    one in JAX."""
    kw = dict(num_classes=NUM_CLASSES, dan_dims=DAN, dan_dropout=0.0, seed_cap=16,
              **VARIANTS[variant])
    sample = _sample(3)
    jm = JaxMultiInputRCNN(dtype=jnp.float32, **kw)
    params = _jax_params(jm, sample)

    def jax_total(p):
        losses = jm.apply({"params": p}, {k: jnp.asarray(v) for k, v in sample.items()},
                          train=True)
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, want), grads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(params)

    tm = load_weights(MultiInputRCNN(device="meta", **kw), state_dict_from_flax(params),
                      "cpu").train()
    losses = tm.loss(_torch_batch(sample))
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    total.backward()

    assert set(losses) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(grads))
    for name, p in tm.named_parameters():
        g_jax = np.asarray(_leaf(grads, _flax_path(name)))
        if name.split(".")[1] in ("plain1", "plain2"):
            assert p.grad is None and not p.requires_grad and not g_jax.any(), name
            continue
        atol = 1e-5 * float(np.abs(g_jax).max()) + 1e-8
        np.testing.assert_allclose(_flax_layout(p.grad), g_jax, rtol=1e-3, atol=atol,
                                   err_msg=name)


def test_flax_init_tree_and_port_model_load_each_other():
    """A JAX init(train=True) tree loads strictly into the port's training
    model, and the port's parameters map back onto the same tree, leaf for
    leaf."""
    sample = _sample(4)
    jm = JaxMultiInputRCNN(num_classes=NUM_CLASSES, dan_dims=DAN, dtype=jnp.float32)
    params = _jax_params(jm, sample)
    tm = load_weights(MultiInputRCNN(num_classes=NUM_CLASSES, dan_dims=DAN, device="meta"),
                      state_dict_from_flax(params), "cpu")
    back = {}
    for name, p in tm.named_parameters():
        node = back
        *path, leaf = _flax_path(name)
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = _flax_layout(p)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    frozen = {n for n, p in tm.named_parameters() if not p.requires_grad}
    assert frozen == {n for n, _ in tm.named_parameters() if n.split(".")[1] in ("plain1", "plain2")}


def _cfgs(iter_size):
    opts = ["MODEL.ROI_BOX_HEAD.DAN_DIM", list(DAN), "TPU.COMPUTE_DTYPE", "float32",
            "TPU.PGT_SEED_CAPACITY", 16, "SOLVER.IMS_PER_BATCH", 1, "SOLVER.BASE_LR", 0.01,
            "SOLVER.WARMUP_ITERS", 10, "WSL.ITER_SIZE", iter_size]
    cfgs = []
    for make in (get_cfg, jax_get_cfg):
        cfg = make()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(list(opts))
        cfgs.append(cfg)
    return cfgs


def test_trainer_matches_jax_trainer():
    """(h) Stage1Trainer.train(0, 3) with WSL.ITER_SIZE 2 against the JAX
    Stage1Trainer on the same batches and start weights, dropout 0: the
    parameters after the one update (steps 0-1), the gradient accumulated at
    step 2, and each step's logged total loss."""
    cfg, jcfg = _cfgs(2)
    samples = [_sample(10), _sample(11), _sample(12)]
    jm = JaxMultiInputRCNN.from_cfg(jcfg, dan_dropout=0.0, dtype=jnp.float32)
    params = _jax_params(jm, samples[0])

    def stream():
        yield from ([s] for s in samples)

    jt = JaxStage1Trainer(jcfg, model=jm, data_iter=stream())
    jt.init_state(stack_batch([samples[0]]))
    jt.state["params"] = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state["opt_state"] = jt.tx.init(jt.state["params"])
    jt.train(0, 3)

    tm = load_weights(MultiInputRCNN.from_cfg(cfg, device="meta", dan_dropout=0.0),
                      state_dict_from_flax(params), "cpu")
    tt = Stage1Trainer(cfg, tm, stream())
    assert tm.training
    tt.train(0, 3)

    assert tt.iter == jt.iter == 3
    np.testing.assert_allclose(tt.storage.histories()["total_loss"].latest,
                               jt.storage.histories()["total_loss"].latest, rtol=1e-4)
    acc = jt.state["opt_state"].acc_grads
    for name, p in tm.named_parameters():
        path = _flax_path(name)
        np.testing.assert_allclose(_flax_layout(p), np.asarray(_leaf(jt.state["params"], path)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        if p.requires_grad:
            g = np.asarray(_leaf(acc, path))
            np.testing.assert_allclose(_flax_layout(p.grad) * 2, g, rtol=1e-3,
                                       atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=name)
    moved = tm.roi_heads.dan.fc1.weight.detach().numpy().T - params["roi_heads"]["dan"]["fc1"]["kernel"]
    assert np.abs(moved).max() > 0
    assert isinstance(jt.state["opt_state"], optax.MultiStepsState)


def test_trainer_raises_on_nan_loss():
    cfg, _ = _cfgs(1)
    bad = _sample(5)
    bad["images_s1"] = np.full_like(bad["images_s1"], np.nan)
    tt = Stage1Trainer(cfg, build_synthetic_model(cfg, "cpu", 0), iter([[bad]]))
    with pytest.raises(FloatingPointError):
        tt.train(0, 1)
