"""The stage-1 CLI with TPU.MODEL_AXIS_SIZE 2 (tensor parallelism of the
DAN fc stack, sos_wsod_torch/parallel/tensor.py) on the CPU over gloo.

  - at world 2 (dp1 x tp2): 3 steps with a checkpoint after the second and
    the evaluation after training on both ranks (each tensor-parallel group
    its share of the test images, rank 0 the whole); the checkpoints are in
    the one-process layout (fc1, fc2 and their momenta whole), written by
    rank 0 alone; then --resume from the step-2 checkpoint (the loader
    starts its stream again, as detectron2's does); in the same ranks,
    ``check_ddp.train_report``'s 3 steps of given batches with a checkpoint
    after the second and a resumed third, bit for bit the straight third on
    both ranks, generator states too;
  - at world 1 the same key is ignored (as the JAX CLI on one chip): the
    step-2 checkpoint of the tp = 2 run resumes in one process, whose step
    matches the tp = 2 resumed step (f32: within 1e-6 of each weight's
    update plus 1e-6 of the weight, plus 1e-9), and --eval-only loads the
    tp = 2 final checkpoint and gives the AP50 of the tp = 2 run's own
    evaluation of it;
  - the stage-2 CLI does not read the key (as the JAX one): --eval-only runs
    with it set.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from sos_wsod_torch.engine import launch as launch_mod
from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import (
    build_synthetic_model, load_config, write_stage2_checkpoint, write_synthetic_voc)
from sos_wsod_torch.tools import check_ddp
from sos_wsod_torch.tools import train_net_stage1 as cli
from sos_wsod_torch.tools import train_net_unbias
from test_torch_ddp import SPLIT_OPTS, SPLITS, TINY
from test_torch_tensor_parallel_step import OPTS
from test_torch_train_slice import CONFIG, _sample

STAGE2 = os.path.join(os.path.dirname(CONFIG), "..", "stage23", "voc_baseline.yaml")
TP_OPTS = [*TINY, "SOLVER.IMS_PER_BATCH", "1", "TPU.MODEL_AXIS_SIZE", "2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_tp_cli")
    write_synthetic_voc(str(root), SPLITS, (60, 80), 30, seed=0)
    return root


def test_stage1_cli_tensor_parallel_trains_saves_one_process_layout_and_resumes(tree,
                                                                               monkeypatch):
    out_dir = str(tree / "tp2")
    base = ["--config-file", CONFIG, *TP_OPTS, "SOLVER.CHECKPOINT_PERIOD", "2",
            "TEST.EVAL_PERIOD", "0", "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out_dir]
    steps_spec = tree / "steps.pt"
    torch.save({"kind": "stage1", "config": CONFIG, "opts": OPTS, "dan_dropout": 0.5,
                "model": build_synthetic_model(load_config(CONFIG, OPTS), "cpu", 0).state_dict(),
                "batches": [[_sample(51)], [_sample(52)], [_sample(53)]], "threads": 1,
                "tp": 2, "resume_at": 2, "report_model": False}, steps_spec)
    (tree / "steps").mkdir()
    tasks = [{"name": "straight", "cli": "stage1", "argv": base},
             {"name": "resumed", "cli": "stage1", "marker": "model_0000001.pth",
              "output_dir": out_dir, "argv": ["--resume", *base]},
             {"name": "steps", "cli": "steps", "spec": str(steps_spec),
              "out_dir": str(tree / "steps")}]
    report = tree / "report"
    report.mkdir()
    launch_mod.launch(check_ddp.run_tasks, 2, args=(tasks, str(report), str(tree), 1),
                      backend="gloo", device="cpu")
    (s0, res0, st0), (s1, res1, st1) = check_ddp.load_reports(str(report), 2)
    assert s0["saved"] == ["model_0000001.pth", "model_final.pth"] and s1["saved"] == []
    assert [r["iter"] for r in s0["records"]] == [r["iter"] for r in s1["records"]] == [0, 1, 2]
    # the replicated part of the ranks' weights agrees, the shards differ
    for a, b in zip(s0["records"], s1["records"]):
        assert a["digest"].split(":")[0] == b["digest"].split(":")[0]
        assert a["digest"].split(":")[1] != b["digest"].split(":")[1]
    assert [r["iter"] for r in res0["records"]] == [r["iter"] for r in res1["records"]] == [2]
    # the ranks drew alike: one generator state for the one data-parallel rank
    assert torch.equal(s0["generator"], s1["generator"])
    for st in (st0, st1):
        assert st["tp"] == 2 and st["resumed"]["start"] == 2
        assert [r["digest"] for r in st["resumed"]["records"]] == [st["records"][2]["digest"]]
        assert torch.equal(st["resumed"]["generator"], st["generator"])

    ckpt = torch.load(os.path.join(out_dir, "model_0000001.pth"), weights_only=True)
    fc1 = ckpt["model"]["roi_heads.dan.fc1.weight"]
    assert fc1.shape == (16, 512 * 49)
    assert ckpt["model"]["roi_heads.dan.fc2.weight"].shape == (16, 16)
    groups = ckpt["optimizer"]["param_groups"]
    idx = {g["name"]: g["params"][0] for g in groups}
    assert ckpt["optimizer"]["state"][idx["roi_heads.dan.fc1.weight"]][
        "momentum_buffer"].shape == fc1.shape
    assert len(ckpt["generators"]) == 1
    metrics = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.json"))]
    ap50 = [m["voc_2007_test/bbox/AP50"] for m in metrics if "voc_2007_test/bbox/AP50" in m]
    assert len(ap50) == 2   # the straight run's and the resumed one's

    # world 1: the step-2 checkpoint resumes in one process
    monkeypatch.chdir(tree)
    one_dir = tree / "one"
    one_dir.mkdir()
    (one_dir / "model_0000001.pth").write_bytes((tree / "tp2" / "model_0000001.pth").read_bytes())
    (one_dir / "last_checkpoint").write_text("model_0000001.pth")
    argv = ["--resume", "--config-file", CONFIG, *TP_OPTS, "SOLVER.CHECKPOINT_PERIOD", "0",
            "TEST.EVAL_PERIOD", "0", "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", str(one_dir)]
    trainer = cli.main(default_argument_parser().parse_args(argv))
    assert trainer.tp_dims == {} and trainer.ddp is None and trainer.iter == 3
    start = ckpt["model"]
    want = torch.load(os.path.join(out_dir, "model_final.pth"), weights_only=True)["model"]
    for k, v in trainer.model.state_dict().items():
        if not v.is_floating_point():
            continue
        change = (want[k] - start[k]).abs().max()
        tol = 1e-6 * change + 1e-6 * want[k].abs() + 1e-9
        assert ((v - want[k]).abs() <= tol).all(), (k, float((v - want[k]).abs().max()))

    results = cli.main(default_argument_parser().parse_args(
        ["--eval-only", "--config-file", CONFIG, *TP_OPTS, "OUTPUT_DIR", out_dir]))
    np.testing.assert_allclose(results["voc_2007_test"]["bbox"]["AP50"], ap50[-1], atol=1e-6)


def test_stage2_cli_runs_with_the_model_axis_key_set(tree, monkeypatch):
    monkeypatch.chdir(tree)
    cfg = load_config(STAGE2, SPLIT_OPTS)
    write_stage2_checkpoint(str(tree / "s2"), cfg, seed=0)
    results = train_net_unbias.main(default_argument_parser().parse_args(
        ["--config-file", STAGE2, "--eval-only", *SPLIT_OPTS, "TPU.MODEL_AXIS_SIZE", "2",
         "OUTPUT_DIR", str(tree / "s2")]))
    assert np.isfinite(results["voc_2007_test"]["bbox"]["AP50"])
