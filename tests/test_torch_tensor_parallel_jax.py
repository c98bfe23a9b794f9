"""A dp2 x tp2 training step of the port (4 gloo ranks on the CPU,
sos_wsod_torch/parallel/tensor.py) against the JAX package's tensor-parallel
step: its Stage1Trainer on a (data = 2, model = 2) mesh of 4 virtual CPU
devices, the DAN fc stack sharded by DAN_TP_RULES, over the same global
batch of 4 images from the same weights. Dropout 0, as in
tests/test_torch_ddp.py's data-parallel parity (neither run draws).

Tolerances: those of the data-parallel parity (tests/test_torch_ddp.py):
total_loss within rtol 1e-4, every parameter after SGD within rtol 1e-5 /
atol 1e-7 of JAX's; the ranks of a tensor-parallel group hold the same
weights, and the two groups' gathered weights are bit-identical.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sos_wsod_tpu.engine.trainer import Stage1Trainer as JaxStage1Trainer
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_tpu.parallel.mesh import make_mesh
from sos_wsod_tpu.parallel.sharding_rules import place_state, state_shardings, tp_enabled
from sos_wsod_torch.engine import launch as launch_mod
from sos_wsod_torch.engine.synthetic import build_synthetic_model, load_config
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN
from sos_wsod_torch.tools import check_ddp
from test_torch_train_slice import (
    CONFIG, _cfgs, _flax_layout, _flax_path, _leaf, _sample)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_tree(cfg) -> dict:
    """The port's seeded weights of ``cfg`` as a flax tree, with
    ``_jax_params``'s spread (conv biases N(0, 0.05), the head kernels x 30:
    no mining near-ties between the two frameworks). Built from the port
    rather than by the JAX model's eager init, which takes ~20 s here."""
    tree: dict = {}
    for name, t in build_synthetic_model(cfg, "cpu", 0).state_dict().items():
        *path, leaf = _flax_path(name)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(_flax_layout(t))
    rng = np.random.RandomState(0)
    for stage in tree["backbone"].values():
        for conv in stage.values():
            conv["bias"] = rng.normal(0, 0.05, conv["bias"].shape).astype(np.float32)
    heads = tree["roi_heads"]
    for name in ["wsddn"] + [f"box_refinery_{k}" for k in range(4)]:
        for sub in heads[name].values():
            sub["kernel"] = sub["kernel"] * 30.0
    return tree


def test_dp2_tp2_step_matches_the_jax_tensor_parallel_step(tmp_path):
    cfg, jcfg = _cfgs(1)
    samples = [_sample(41), _sample(42), _sample(43), _sample(44)]
    jm = JaxMultiInputRCNN.from_cfg(jcfg, dan_dropout=0.0, dtype=jnp.float32)
    params = _flax_tree(cfg)
    mesh = make_mesh(devices=jax.devices()[:4], model_axis_size=2)
    assert tp_enabled(mesh) and dict(mesh.shape) == {"data": 2, "model": 2}
    jt = JaxStage1Trainer(jcfg, model=jm, data_iter=iter([samples]), mesh=mesh)
    state = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "iter": jnp.zeros((), jnp.int32)}
    state["opt_state"] = jt.tx.init(state["params"])
    # the JAX trainer's init_state placement, on the given weights
    jt._state_shardings = state_shardings(state, mesh)
    assert jt._state_shardings["params"]["roi_heads"]["dan"]["fc1"]["kernel"].spec == \
        P(None, "model")
    jt.state = place_state(state, jt._state_shardings)
    jt.train(0, 1)
    want_total = jt.storage.histories()["total_loss"].latest

    opts = ["MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64], "TPU.COMPUTE_DTYPE", "float32",
            "TPU.PGT_SEED_CAPACITY", 16, "SOLVER.IMS_PER_BATCH", 4, "SOLVER.BASE_LR", 0.01,
            "SOLVER.WARMUP_ITERS", 10, "WSL.ITER_SIZE", 1, "MODEL.DEVICE", "cpu"]
    spec = tmp_path / "spec.pt"
    torch.save({"kind": "stage1", "config": CONFIG, "opts": opts, "dan_dropout": 0.0,
                "model": state_dict_from_flax(params), "batches": [samples], "threads": 1,
                "tp": 2}, spec)
    launch_mod.launch(check_ddp.train_steps, 4, args=(str(spec), str(tmp_path)),
                      backend="gloo", device="cpu")
    reports = check_ddp.load_reports(str(tmp_path), 4)
    assert [r["tp"] for r in reports] == [2] * 4 and all(r["ddp"] for r in reports)
    for r in reports[1:]:
        assert all(torch.equal(r["model"][k], reports[0]["model"][k]) for k in r["model"])
    (_, total), = reports[0]["scalars"]["total_loss"]
    np.testing.assert_allclose(total, want_total, rtol=1e-4)
    tm = load_weights(MultiInputRCNN.from_cfg(load_config(CONFIG, opts), device="meta",
                                              dan_dropout=0.0), reports[0]["model"], "cpu")
    got_params = jax.device_get(jt.state["params"])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_flax_layout(p), np.asarray(_leaf(got_params,
                                                                     _flax_path(name))),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    moved = tm.roi_heads.dan.fc2.weight.detach().numpy().T - \
        params["roi_heads"]["dan"]["fc2"]["kernel"]
    assert np.abs(moved).max() > 0
