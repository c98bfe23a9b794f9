"""The port's single-view WSOD model (sos_wsod_torch/models/meta/
rcnn_wsl_single.py: GeneralizedRCNNWSL with the WSDDN, OICR, PCL, CMIL and
ContextLocNet heads) against the JAX package's, on the CPU in float32, for
each head: every loss term and every parameter gradient against the JAX
model's eager ``model.apply`` under ``jax.value_and_grad`` (the JAX train
step cannot run PCL or CMIL: their host callbacks do not batch under its
vmap), one SGD step and then ``predict``'s scores and boxes, the weights
carried from a JAX tree and from d2-WSL blobs, and the single-view mapper and
loader against the JAX package's.

Inputs are small (VGG16 at full width on a 48 x 64 canvas, DAN 32/32, 3
classes, 24 proposal slots with 20 valid, 3 refinement branches). Dropout is
off on both sides (the JAX DAN has no rate option: the test replaces its
dropout with the identity). The JAX ROIPool splits the gradient of tied
maxima where the port routes it to the first hit; the ties here are the
zeros of ReLU and of the padded canvas, whose gradient the ReLU and mask
backward zero on both sides, and the conv biases are random so that no ReLU
input sits within rounding of 0.

Tolerances (two f32 implementations that sum convolutions and GEMMs in
different orders): loss terms within rtol 1e-4 / atol 1e-5; gradients within
rtol 1e-4 and an atol of 1e-5 of the leaf's largest entry (plus 1e-8 for
leaves whose gradient is 0); scores after the step within rtol 1e-4 / atol
1e-6; boxes exact (decoded from regression deltas: within 1e-3 px), and
integer targets and mapped arrays exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.data import build as jax_build
from sos_wsod_tpu.data.mapper_multi import DatasetMapperSingle as JaxDatasetMapperSingle
from sos_wsod_tpu.engine.weights import vgg_wsl_param_tree
from sos_wsod_tpu.models.heads import dan as jax_dan
from sos_wsod_tpu.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL as JaxGeneralizedRCNNWSL
from sos_wsod_torch.data.build import batched_stream
from sos_wsod_torch.data.mapper_multi import DatasetMapperSingle
from sos_wsod_torch.engine.synthetic import random_d2_wsl_blobs, synthetic_train_dicts
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_d2_wsl, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL

NUM_CLASSES = 3
DAN = (32, 32)
P = 24
ITER = 20
HEADS = {"WSDDN": "ROIPool", "OICR": "ROIPool", "PCL": "ROIPool", "CMIL": "ROIPool",
         "ContextLocNet": "ROILoopPool"}
KW = dict(num_classes=NUM_CLASSES, dan_dims=DAN, refine_k=3, refine_reg=(False, False, False),
          size_epoch=50, max_iter=1000, detections_per_image=10)


@pytest.fixture(autouse=True)
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(jax_dan, "HwDropout", lambda rate: (lambda x, deterministic: x))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small multi-threaded ops slow down badly under the test
    workers; one thread is fast and gives the same numbers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(seed, canvas=(48, 64), valid=(44, 60)):
    """One image on a padded canvas, P proposal slots (the last 4 padding),
    classes 0 and 2 present."""
    rng = np.random.RandomState(seed)
    img = np.zeros(canvas + (3,), np.float32)
    img[:valid[0], :valid[1]] = rng.uniform(0, 255, valid + (3,))
    h, w = valid
    x1, y1 = rng.uniform(0, w - 12, P), rng.uniform(0, h - 12, P)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(8, w / 2, P), w),
                      np.minimum(y1 + rng.uniform(8, h / 2, P), h)], 1).astype(np.float32)
    gt = np.zeros(NUM_CLASSES, np.float32)
    gt[[0, 2]] = 1
    return {"image": img, "valid_hw": np.array(valid, np.int32), "boxes": boxes,
            "objectness": rng.uniform(0, 1, P).astype(np.float32),
            "prop_valid": np.arange(P) < P - 4, "gt_classes_oh": gt,
            "image_hw": np.array(valid, np.float32)}


def _jax_batch(sample):
    return {**{k: jnp.asarray(v) for k, v in sample.items()}, "iter": jnp.asarray(ITER)}


def _torch_batch(sample):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sample.items()}


def _jax_model(head, **kw):
    return JaxGeneralizedRCNNWSL(head=head, pooler_type=HEADS[head], dtype=jnp.float32,
                                 **{**KW, **kw})


def _jax_params(jm, sample):
    """The JAX model's own init, random conv biases, and the refinement
    branches' logits spread so that mining ranks are not near-ties."""
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)}, _jax_batch(sample),
                                    True)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(0)
    for stage in params["backbone"].values():
        for conv in stage.values():
            conv["bias"] = rng.normal(0, 0.05, conv["bias"].shape).astype(np.float32)
    for name, sub in params["roi_heads"].items():
        if name.startswith("box_refinery"):
            for leaf in sub.values():
                leaf["kernel"] = leaf["kernel"] * 30.0
    return params


def _port_model(head, params, **kw):
    tm = GeneralizedRCNNWSL(head=head, pooler_type=HEADS[head], dan_dropout=0.0, device="meta",
                            **{**KW, **kw})
    return load_weights(tm, state_dict_from_flax(params, dan_channels_last=False), "cpu")


def _flax_grad(name: str, grad: torch.Tensor) -> np.ndarray:
    """A port gradient in the flax layout of the single-view JAX tree: conv
    OIHW -> HWIO, Linear (out, in) -> (in, out), and DAN fc1's inputs from
    the port's (h, w, c) order back to (c, h, w)."""
    a = grad.detach().numpy()
    if name == "roi_heads.dan.fc1.weight":
        out_dim, in_dim = a.shape
        a = a.reshape(out_dim, 49, in_dim // 49).transpose(0, 2, 1).reshape(out_dim, in_dim)
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T if a.ndim == 2 else a


def _leaf(tree, name):
    *path, leaf = name.split(".")
    for p in path:
        tree = tree[p]
    return tree["kernel" if leaf == "weight" else "bias"]


def _jax_loss_and_grads(jm, params, sample):
    def total(p):
        losses = jm.apply({"params": p}, _jax_batch(sample), True)
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
    return jax.tree_util.tree_map(np.asarray, losses), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("head,refine_reg", [("WSDDN", None), ("OICR", None),
                                              ("OICR", (True, False, True))])
def test_losses_gradients_step_and_predict_match_jax(head, refine_reg):
    """Loss terms and every gradient leaf of one image, then one SGD step
    (lr 0.01) on each side's own gradients, then predict's scores and boxes
    on the stepped weights; OICR also with box regression on branches 0 and
    2 (its loss terms, and predict's boxes decoded by the mean deltas). PCL
    and CMIL: tests/test_torch_single_view_mil.py; ContextLocNet:
    tests/test_torch_single_view_loop.py (the JAX side's first eager run
    compiles each op, so the heads are split over files, which the test
    workers run side by side)."""
    check_head(head, refine_reg)


def check_head(head, refine_reg=None):
    sample = _sample(1)
    kw = {} if refine_reg is None else {"refine_reg": refine_reg}
    jm = _jax_model(head, **kw)
    params = _jax_params(jm, sample)
    want, grads = _jax_loss_and_grads(jm, params, sample)

    tm = _port_model(head, params, **kw).train()
    losses = tm.loss(_torch_batch(sample), cur_iter=ITER)
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    assert set(losses) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(losses[k].item(), float(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(grads))
    for name, p in tm.named_parameters():
        g = _leaf(grads, name)
        if name.split(".")[1] in ("plain1", "plain2"):
            assert p.grad is None and not p.requires_grad and not g.any(), name
            continue
        np.testing.assert_allclose(_flax_grad(name, p.grad), g, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(g).max()) + 1e-8, err_msg=name)

    lr = 0.01
    stepped = jax.tree_util.tree_map(lambda w, d: w - lr * d, params, grads)
    _, scores_j, boxes_j = jm.apply({"params": stepped}, _jax_batch(sample), False)
    with torch.no_grad():
        for p in tm.parameters():
            if p.grad is not None:
                p -= lr * p.grad
        det, scores, boxes = tm.eval().predict(_torch_batch(sample))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), rtol=1e-4, atol=1e-6)
    if refine_reg is None:
        np.testing.assert_array_equal(boxes.numpy(), np.asarray(boxes_j))
    else:       # decoded by f32 deltas that differ within the scores' tolerance
        np.testing.assert_allclose(boxes.numpy(), np.asarray(boxes_j), rtol=1e-5, atol=1e-3)
    assert scores.shape == (P, NUM_CLASSES + 1) and det.valid.any()


@pytest.mark.parametrize("head", ["WSDDN", "OICR"])
def test_weights_from_a_jax_tree_and_from_d2_wsl_blobs(head):
    """A JAX init tree loads strictly, fc1 reordered from (c, h, w) to the
    port's (h, w, c) and every other leaf as it is; d2-WSL blobs (the names
    the multi-input and single-view checkpoints share) load strictly with
    the weights the head has no place for dropped, and give the scores the
    JAX model gives on its tree of the same blobs
    (``vgg_wsl_param_tree(dan_channels_last=False)``)."""
    check_weights(head)


def check_weights(head):
    sample = _sample(2)
    jm = _jax_model(head)
    params = _jax_params(jm, sample)
    sd = _port_model(head, params).state_dict()
    for name, v in sd.items():
        np.testing.assert_array_equal(_flax_grad(name, v), _leaf(params, name), err_msg=name)

    blobs = random_d2_wsl_blobs(3, NUM_CLASSES, 3, DAN)
    tm = GeneralizedRCNNWSL(head=head, pooler_type=HEADS[head], device="meta", **KW)
    tm = load_weights(tm, state_dict_from_d2_wsl(blobs, keep=tm.state_dict()), "cpu")
    with torch.no_grad():
        scores = tm.predict_scores(_torch_batch(sample))[0]
    tree = vgg_wsl_param_tree(blobs, dan_channels_last=False)
    tree["roi_heads"] = {k: v for k, v in tree["roi_heads"].items()
                         if k in params["roi_heads"]}
    for k in range(3):       # single-view branches without regression have no bbox_pred
        tree["roi_heads"].get(f"box_refinery_{k}", {}).pop("bbox_pred", None)
    _, want, _ = jm.apply({"params": tree}, _jax_batch(sample), False)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def _mappers(**kw):
    args = dict(min_size_train=(40, 48, 56), max_size_train=100, crop_enabled=True,
                random_flip=True, proposal_topk=30, proposal_capacity=32, num_classes=20,
                size_divisibility=32, seed=5, **kw)
    return DatasetMapperSingle(**args), JaxDatasetMapperSingle(**args)


def test_single_view_mapper_matches_jax():
    """Eight images in stream order from one seed (crop, short edge and flip
    drawn from the mapper's RandomState): every array equal, and the
    proposal-bucket choice too."""
    dicts = synthetic_train_dicts(8, (60, 80), 40, 20, seed=1)
    for buckets in ((), (16, 32)):
        port, jax_mapper = _mappers(proposal_buckets=buckets)
        for d in dicts:
            got, want = port(d), jax_mapper(d)
            assert set(got) == set(want)
            for k in want:
                if k == "image_id":
                    assert got[k] == want[k]
                else:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_single_view_loader_batches_match_jax():
    """batched_stream over single-view samples: aspect grouping and the
    shared canvas of each batch of 2, as the JAX package's, for 4 batches,
    with the mapper's planned draws run on 2 threads."""
    dicts = synthetic_train_dicts(6, (60, 80), 40, 20, seed=2)
    dicts[1]["image"] = dicts[1]["image"].transpose(1, 0, 2).copy()     # a tall one
    port, jax_mapper = _mappers()
    got = batched_stream(dicts, port, 2, seed=3, size_divisibility=32, num_workers=2)
    want = jax_build.batched_stream(dicts, jax_mapper, 2, seed=3, size_divisibility=32)
    for _ in range(4):
        for g, w in zip(next(got), next(want)):
            for k in w:
                if k != "image_id":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got.close()
