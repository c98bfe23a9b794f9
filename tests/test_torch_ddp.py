"""The port's data parallelism on the CPU: two processes over gloo, started
by sos_wsod_torch/engine/launch.py, each running a function of
sos_wsod_torch/tools/check_ddp.py (which chip_smoke.py's phase 14 runs on
the card) and writing what it saw.

  - the launcher's contract: more than one machine needs a tcp:// address,
    more ranks than cards raise before any process starts (NCCL), a world of
    one runs in this process with no process group, and a CLI's main called
    with --num-gpus 2 outside the launcher refuses, as does one whose world
    TPU.MODEL_AXIS_SIZE does not divide;
  - the loaders: each rank's stage-1 and two-crop streams are disjoint and
    their union is the single-process stream of the same global batch;
  - stage 1: one DDP step of 2 ranks x 1 image (dropout 0, so neither run
    draws) against the JAX package's Stage1Trainer on the 2-image batch
    (tests/test_torch_train_slice.py's model, weights and tolerances:
    parameters after SGD within rtol 1e-5 / atol 1e-7, total_loss within
    rtol 1e-4), the two ranks bit-identical after the step;
  - the split tool at world 2 writes a dataseed byte-identical to one
    process's;
  - the stage-1 CLI at world 2 writes each checkpoint and metrics.json once,
    from rank 0, evaluates on rank 0, resumes on both ranks, and its
    checkpoint loads in one process's --eval-only.
(tests/test_torch_ddp_ssod.py holds the stage-2/3 steps and the resume of a
world-2 checkpoint.)
Each scenario is one spawn of two processes (about 6 s to start here), with
torch in one thread a process.
"""
from __future__ import annotations

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.engine.trainer import Stage1Trainer as JaxStage1Trainer, stack_batch
from sos_wsod_tpu.models.meta.rcnn_wsl import MultiInputRCNN as JaxMultiInputRCNN
from sos_wsod_torch.data.build import training_index_stream
from sos_wsod_torch.engine import launch as launch_mod
from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import (
    load_config, write_pseudo_labels, write_stage2_checkpoint, write_synthetic_voc)
from sos_wsod_torch.engine.weights import load_weights, state_dict_from_flax
from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN
from sos_wsod_torch.parallel import comm
from sos_wsod_torch.tools import check_ddp, splits
from sos_wsod_torch.tools import train_net_stage1 as cli
from test_torch_train_slice import (
    CONFIG, _cfgs, _flax_layout, _flax_path, _jax_params, _leaf, _sample)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT = str(ROOT / "configs" / "stage23" / "voc_split.yaml")
SPLITS = (("train", 4), ("val", 2), ("test", 2))
TINY = ["MODEL.ROI_BOX_HEAD.DAN_DIM", "[16, 16]", "TPU.COMPUTE_DTYPE", "float32",
        "INPUT.MIN_SIZE_TRAIN", "(40, 48)", "INPUT.MIN_SIZE_TEST", "48",
        "TPU.PROPOSAL_CAPACITY", "32", "TPU.PGT_SEED_CAPACITY", "16",
        "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "0", "MODEL.DEVICE", "cpu",
        "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.01"]
SPLIT_OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "14",
              "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
              "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", "2", "MODEL.RPN.PRE_NMS_TOPK_TRAIN",
              "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE",
              "32", "MODEL.DEVICE", "cpu", "INPUT.MIN_SIZE_TEST", "48", "TPU.PGT_CAPACITY", "8"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops in one thread (pytest-xdist runs several test
    processes on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gloo(fn, *args, world=2):
    launch_mod.launch(fn, world, args=args, backend="gloo", device="cpu")


def test_launch_needs_a_tcp_address_for_more_than_one_machine():
    with pytest.raises(ValueError, match="tcp://"):
        launch_mod.launch(print, 1, num_machines=2, dist_url="auto", device="cpu")
    with pytest.raises(ValueError, match="machine-rank"):
        launch_mod.launch(print, 1, num_machines=2, machine_rank=2,
                          dist_url="tcp://127.0.0.1:1", device="cpu")


def test_launch_refuses_more_ranks_than_cards(monkeypatch):
    """NCCL takes a card a rank: --num-gpus beyond the cards raises before
    anything is spawned; only gloo (the tests' and the smoke's choice) may
    put two ranks on one card."""
    spawned = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(launch_mod, "spawn", lambda *a, **k: spawned.append((a, k)))
    with pytest.raises(RuntimeError, match="--num-gpus 2 but this machine has 1"):
        launch_mod.launch(print, 2, device="cuda")
    with pytest.raises(RuntimeError, match="--num-gpus 4"):
        launch_mod.launch(print, 4, device="cuda", backend="nccl")
    assert not spawned
    launch_mod.launch(print, 2, device="cuda", backend="gloo")
    assert len(spawned) == 1 and spawned[0][1]["backend"] == "gloo"


def test_launch_at_world_one_runs_here_without_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    seen = []

    def main(x):
        seen.append((x, comm.is_initialized(), comm.get_rank(), comm.get_world_size()))
        return x + 1

    assert launch_mod.launch(main, 1, args=(41,), device="cuda") == 42
    assert seen == [(41, False, 0, 1)]
    assert comm.process_gather([1, 2]) == [1, 2]
    d = {"a": torch.tensor(1.5)}
    assert comm.reduce_dict(d) is d
    assert comm.derive_seed(1234, 0) == 1234 and comm.derive_seed(1234, 1) != 1234
    assert comm.local_batch_size(4) == 4


def test_cli_main_with_num_gpus_outside_the_launcher_refuses(tmp_path, monkeypatch):
    """Also: a world that TPU.MODEL_AXIS_SIZE does not divide raises before
    any group is made, as the JAX package's make_mesh does."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no process group"):
        cli.main(default_argument_parser().parse_args(
            ["--num-gpus", "2", "--config-file", CONFIG, *TINY, "OUTPUT_DIR", "refused"]))
    monkeypatch.setattr(comm, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="3 processes not divisible by MODEL_AXIS_SIZE=2"):
        cli.main(default_argument_parser().parse_args(
            ["--config-file", CONFIG, *TINY, "OUTPUT_DIR", "refused", "TPU.MODEL_AXIS_SIZE",
             "2"]))


def test_loaders_give_each_rank_a_disjoint_share_of_one_stream(tmp_path):
    """Stage 1 (SOLVER.IMS_PER_BATCH 4 over 2 ranks) and the two-crop loader
    (2 + 2 a step): each rank's ids are its half of every global batch of the
    single-process stream, and the ranks' ids differ."""
    n, batches = 12, 5
    _gloo(check_ddp.loader_ids, str(tmp_path), n, 4, 2, 2, batches, 1234)
    r0, r1 = check_ddp.load_reports(str(tmp_path), 2)
    stream = training_index_stream(n, seed=1234)
    one = [[100 + next(stream) for _ in range(4)] for _ in range(batches)]
    for step, (a, b) in enumerate(zip(r0["stage1"], r1["stage1"])):
        assert len(a) == len(b) == 2
        assert sorted(a + b) == sorted(one[step]), step
    flat0 = [i for b in r0["stage1"] for i in b]
    flat1 = [i for b in r1["stage1"] for i in b]
    # the stream is a permutation an epoch: in the first epoch no id twice
    assert not set(flat0[:4]) & set(flat1[:4])
    for key, offset, seed in (("label_k", 0, 1234), ("unlabel_k", n // 2, 1235)):
        s = training_index_stream(n // 2, seed=seed)
        want = [[100 + offset + next(s) for _ in range(2)] for _ in range(batches)]
        for step in range(batches):
            a, b = r0["semisup"][step][key], r1["semisup"][step][key]
            assert a + b == want[step], (key, step)
            assert r0["semisup"][step][key.replace("_k", "_q")] == a
    labeled = {i for r in (r0, r1) for b in r["semisup"] for i in b["label_k"]}
    unlabeled = {i for r in (r0, r1) for b in r["semisup"] for i in b["unlabel_k"]}
    assert not labeled & unlabeled


def test_stage1_ddp_step_matches_the_jax_step_on_the_global_batch(tmp_path):
    cfg, jcfg = _cfgs(1)
    samples = [_sample(21), _sample(22)]
    jm = JaxMultiInputRCNN.from_cfg(jcfg, dan_dropout=0.0, dtype=jnp.float32)
    params = _jax_params(jm, samples[0])
    jt = JaxStage1Trainer(jcfg, model=jm, data_iter=iter([samples]))
    jt.init_state(stack_batch([samples[0]]))
    jt.state["params"] = jax.tree_util.tree_map(jnp.asarray, params)
    jt.state["opt_state"] = jt.tx.init(jt.state["params"])
    jt.train(0, 1)

    opts = ["MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64], "TPU.COMPUTE_DTYPE", "float32",
            "TPU.PGT_SEED_CAPACITY", 16, "SOLVER.IMS_PER_BATCH", 2, "SOLVER.BASE_LR", 0.01,
            "SOLVER.WARMUP_ITERS", 10, "WSL.ITER_SIZE", 1, "MODEL.DEVICE", "cpu"]
    spec = tmp_path / "spec.pt"
    torch.save({"kind": "stage1", "config": CONFIG, "opts": opts, "dan_dropout": 0.0,
                "model": state_dict_from_flax(params), "batches": [samples], "threads": 1},
               spec)
    _gloo(check_ddp.train_steps, str(spec), str(tmp_path))
    r0, r1 = check_ddp.load_reports(str(tmp_path), 2)
    assert r0["ddp"] and r1["ddp"] and r0["world"] == 2
    assert r0["records"][0]["digest"] == r1["records"][0]["digest"]
    assert all(torch.equal(r0["model"][k], r1["model"][k]) for k in r0["model"])
    (_, total), = r0["scalars"]["total_loss"]
    np.testing.assert_allclose(total, jt.storage.histories()["total_loss"].latest, rtol=1e-4)
    tm = load_weights(MultiInputRCNN.from_cfg(load_config(CONFIG, opts), device="meta",
                                              dan_dropout=0.0), r0["model"], "cpu")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_flax_layout(p), np.asarray(_leaf(jt.state["params"],
                                                                     _flax_path(name))),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    moved = tm.roi_heads.dan.fc1.weight.detach().numpy().T - \
        params["roi_heads"]["dan"]["fc1"]["kernel"]
    assert np.abs(moved).max() > 0


@pytest.fixture(scope="module")
def split_tree(tmp_path_factory):
    """A synthetic VOC tree with pseudo labels and a stage-2 checkpoint."""
    root = tmp_path_factory.mktemp("voc_ddp_split")
    write_synthetic_voc(str(root), SPLITS, (60, 80), 30, seed=0)
    write_pseudo_labels(str(root))
    write_stage2_checkpoint(str(root / "out"), load_config(SPLIT, SPLIT_OPTS), seed=0)
    return root


def test_split_at_world_two_writes_the_single_process_dataseed(split_tree, monkeypatch):
    """Rank r scores the images r, r + 2, ...; the gathered scores in
    dataset order give the split of one process, byte for byte, written
    once."""
    monkeypatch.chdir(split_tree)
    argv = ["--config", SPLIT, "--ckpt", "out/model_final", "--k", "3", *SPLIT_OPTS]
    one, percent = splits.main(["--save-path", "dataseed/one.txt", *argv])
    out = split_tree / "ddp_split"
    out.mkdir()
    task = {"name": "split", "cli": "splits", "argv": ["--save-path", "dataseed/two.txt", *argv]}
    _gloo(check_ddp.run_tasks, [task], str(out), str(split_tree), 1)
    r0, r1 = check_ddp.load_reports(str(out), 2)
    assert r0[0]["split"] == r1[0]["split"] == one
    assert (split_tree / "dataseed" / "two.txt").read_bytes() == \
        (split_tree / "dataseed" / "one.txt").read_bytes()
    assert len(one[str(percent)]["1"]) == 3


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_ddp_cli")
    write_synthetic_voc(str(root), SPLITS, (60, 80), 30, seed=0)
    return root


def test_stage1_cli_at_world_two_trains_saves_once_resumes_and_evaluates(cli_tree,
                                                                        monkeypatch):
    """The stage-1 CLI's main at world 2 (IMS_PER_BATCH 2): the replicas
    equal after each step, every checkpoint and metrics.json written by rank
    0 alone, the eval after training on rank 0; --resume from the step-2
    checkpoint starts both ranks at iteration 2; --eval-only in one process
    loads the world-2 checkpoint."""
    out_dir = str(cli_tree / "straight")
    base = ["--config-file", CONFIG, *TINY, "SOLVER.CHECKPOINT_PERIOD", "2",
            "TEST.EVAL_PERIOD", "0", "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", out_dir]
    tasks = [{"name": "straight", "cli": "stage1", "argv": base},
             {"name": "resumed", "cli": "stage1", "marker": "model_0000001.pth",
              "output_dir": out_dir, "argv": ["--resume", *base]}]
    out = cli_tree / "report"
    out.mkdir()
    _gloo(check_ddp.run_tasks, tasks, str(out), str(cli_tree), 1)
    (s0, res0), (s1, res1) = check_ddp.load_reports(str(out), 2)
    assert s0["ddp"] and s1["ddp"]
    assert s0["saved"] == ["model_0000001.pth", "model_final.pth"] and s1["saved"] == []
    assert res0["saved"] == ["model_final.pth"] and res1["saved"] == []
    assert [r["iter"] for r in s0["records"]] == [r["iter"] for r in s1["records"]] == [0, 1, 2]
    assert [r["iter"] for r in res0["records"]] == [r["iter"] for r in res1["records"]] == [2]
    assert not torch.equal(s0["generator"], s1["generator"])
    metrics = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.json"))]
    assert any("total_loss" in m for m in metrics)
    assert any("voc_2007_test/bbox/AP50" in m for m in metrics)
    monkeypatch.chdir(cli_tree)
    results = cli.main(default_argument_parser().parse_args(["--eval-only", *base]))
    assert "voc_2007_test" in results
