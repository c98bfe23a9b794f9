"""A dp1 x tp2 training step of Stage1Trainer (tensor parallelism of the DAN
fc stack, sos_wsod_torch/parallel/tensor.py) on 2 gloo ranks
(``tools/check_ddp.py:train_steps``) against one process's step from the
same weights, batch and seed, on the CPU in f32: with dropout 0.5 (the full
masks drawn and sliced: the same bits) and again with a norm clip on.
Losses within rtol 1e-6; every weight after SGD within 1e-6 of its update's
largest entry plus 1e-6 of the weight's, plus 1e-9 for the WSDDN det bias,
whose true gradient is 0 (fc2's partial products are summed in another
order than one GEMM's). Each rank runs torch in one thread.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from sos_wsod_torch.engine import launch as launch_mod
from sos_wsod_torch.engine.synthetic import build_synthetic_model, load_config
from sos_wsod_torch.tools import check_ddp
from test_torch_train_slice import CONFIG, _sample

OPTS = ["MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64], "TPU.COMPUTE_DTYPE", "float32",
        "TPU.PGT_SEED_CAPACITY", 16, "SOLVER.IMS_PER_BATCH", 1, "SOLVER.BASE_LR", 0.01,
        "SOLVER.WARMUP_ITERS", 0, "MODEL.DEVICE", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return {k: v.clone() for k, v in
            build_synthetic_model(load_config(CONFIG, OPTS), "cpu", 0).state_dict().items()}


def _close_update(name: str, got: torch.Tensor, want: torch.Tensor, start: torch.Tensor) -> None:
    change = (want - start).abs().max()
    tol = 1e-6 * change + 1e-6 * want.abs() + 1e-9
    assert ((got - want).abs() <= tol).all(), (name, float((got - want).abs().max()),
                                               float(change))


@pytest.mark.parametrize("case", ["dropout", "clip_norm"])
def test_dp1_tp2_step_equals_the_one_process_step(tmp_path, weights, case):
    opts = list(OPTS)
    if case == "clip_norm":
        opts += ["SOLVER.CLIP_GRADIENTS.ENABLED", True, "SOLVER.CLIP_GRADIENTS.CLIP_TYPE",
                 "norm", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.05]
    batches = [[_sample(31)]]
    spec = {"kind": "stage1", "config": CONFIG, "opts": opts, "dan_dropout": 0.5,
            "model": weights, "batches": batches, "threads": 1, "tp": 2}
    torch.save(spec, tmp_path / "spec.pt")
    launch_mod.launch(check_ddp.train_steps, 2, args=(str(tmp_path / "spec.pt"), str(tmp_path)),
                      backend="gloo", device="cpu")
    r0, r1 = check_ddp.load_reports(str(tmp_path), 2)
    assert r0["tp"] == r1["tp"] == 2 and r0["ddp"]
    one_model, one = check_ddp.build_trainer(spec, batches)
    assert one.tp_dims == {}
    one.train(0, 1)
    want = one_model.state_dict()
    for r in (r0, r1):
        assert all(torch.equal(r["model"][k], r0["model"][k]) for k in want)
        for k in ("total_loss", "loss_cls"):
            (_, got), = r["scalars"][k]
            np.testing.assert_allclose(got, one.storage.histories()[k].latest, rtol=1e-6)
    assert r0["model"]["roi_heads.dan.fc1.weight"].shape == want["roi_heads.dan.fc1.weight"].shape
    for k, v in want.items():
        if v.is_floating_point():
            _close_update(k, r0["model"][k], v, weights[k])
    moved = (want["roi_heads.dan.fc1.weight"] - weights["roi_heads.dan.fc1.weight"]).abs()
    assert moved.max() > 0
    # the two ranks' replicated weights agree bit for bit, their shards differ
    rep, shard = r0["records"][0]["digest"].split(":")
    assert r1["records"][0]["digest"].split(":")[0] == rep
    assert r1["records"][0]["digest"].split(":")[1] != shard
