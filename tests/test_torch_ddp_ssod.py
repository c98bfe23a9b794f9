"""The port's data parallelism of stages 2-3 on the CPU: two processes over
gloo (sos_wsod_torch/engine/launch.py) run sos_wsod_torch/tools/check_ddp.py's
train_steps, and the result is held against the port's own single-process
step on the global batch, which tests/test_torch_frcnn_train.py and
tests/test_torch_ssod.py hold against the JAX package.

Both runs take the same sampling draws: the ranks record theirs (each from
its own generator, comm.derive_seed(SEED, rank)) and the single-process run
is fed them in its order, image by image (5 draws an image: the RPN's
positives and negatives, the ROI heads' positives, negatives and compaction
noise). The models are the cut R14-FPN of those tests (FPN 32, RPN top-k
64/32, 32 sampled ROIs, fc 64, a fixed 2 x 2 pooler grid, f32) from the
port's seeded initializer, on 64 x 64 images whose gt counts differ between
the ranks' images, so that each image's sampled counts differ and a loss
normalized by a count over the local batch would not give the global mean.

  - stage 2 (voc_baseline, BaselineTrainer): 2 steps of 2 ranks x (1 + 1)
    images against the 2 + 2 batch;
  - stage 3 (voc_ssod, UBTeacherTrainer.semisup_step from BURN_UP_STEP,
    TEACHER_UPDATE_ITER 1): the copy step and an EMA step of 2 ranks x
    (1 + 1 labeled, 1 unlabeled), the box predictor's score bias of one
    class raised so that the teacher keeps pseudo boxes on rank 0's
    unlabeled image (its multi-label lists that class) and none on rank 1's.

And the checkpoint of a world-2 Stage1Trainer (dropout 0.5, so each rank's
generator matters): written once, from rank 0; a second trainer resumed
from it repeats the straight run's next steps bit for bit, every rank's
generator state (and, mid-accumulation, its gradients) included; it loads
into a trainer of one process.

After every step both ranks hold the same student and teacher bits
(ReplicaCheckHook). Tolerances against the single-process step: each loss
term within rtol 1e-5 / atol 1e-7; num_pseudo_boxes exactly; each step's
change of each weight within rtol 1e-4 / atol 1e-6 x its largest entry plus
one f32 unit in the last place of the weight (the new weight rounds to
f32). The two runs differ only in summation order: the backbone runs one
image a rank where the single process runs the batch, and the gradients
meet in DDP's all-reduce where the single process sums them in its
backward.
"""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from sos_wsod_torch.core import sampling
from sos_wsod_torch.engine import launch as launch_mod
from sos_wsod_torch.engine.checkpoint import Checkpointer
from sos_wsod_torch.engine.synthetic import (
    build_synthetic_frcnn, build_synthetic_model, load_config)
from sos_wsod_torch.engine.trainer import Stage1Trainer
from sos_wsod_torch.engine.ubteacher import BaselineTrainer, UBTeacherTrainer
from sos_wsod_torch.tools import check_ddp
from test_torch_train_slice import CONFIG, _sample as _stage1_sample

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = str(ROOT / "configs" / "stage23" / "voc_baseline.yaml")
SSOD = str(ROOT / "configs" / "stage23" / "voc_ssod.yaml")
OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", 14, "MODEL.FPN.OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64, "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO", 2,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 64, "MODEL.RPN.POST_NMS_TOPK_TRAIN", 32,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 64, "MODEL.RPN.POST_NMS_TOPK_TEST", 32,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, "TEST.DETECTIONS_PER_IMAGE", 8,
        "SOLVER.WARMUP_ITERS", 0, "SOLVER.BASE_LR", 0.02, "SEMISUPNET.TEACHER_UPDATE_ITER", 1,
        "MODEL.DEVICE", "cpu"]
HW, G = 64, 8
DRAWS_PER_IMAGE = 5
KEPT, BIAS = 6, 9.0     # the raised class and its raise


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(rng, n_gt, ml=None):
    """A 64 x 64 image with ``n_gt`` gt boxes of G slots."""
    gt_boxes = np.zeros((G, 4), np.float32)
    gt_classes = np.zeros((G,), np.int32)
    for i in range(n_gt):
        side = rng.uniform(12, 40, 2)
        x1, y1 = rng.uniform(0, HW - side)
        gt_boxes[i] = [x1, y1, x1 + side[0], y1 + side[1]]
        gt_classes[i] = rng.integers(20)
    return {"image": rng.uniform(0, 255, (HW, HW, 3)).astype(np.float32),
            "image_hw": np.array([HW, HW], np.float32), "gt_boxes": gt_boxes,
            "gt_classes": gt_classes, "gt_valid": np.arange(G) < n_gt,
            "multi_label_oh": np.ones(20, np.float32) if ml is None else ml}


def _batch(rng):
    """Global two-crop batch: 2 + 2 labeled images (rank 0's with 1 gt box,
    rank 1's with 5), 2 unlabeled pairs, the first listing KEPT."""
    lq = [_sample(rng, 1), _sample(rng, 5)]
    lk = [_sample(rng, 2), _sample(rng, 4)]
    ml = np.zeros((2, 20), np.float32)
    ml[0, [KEPT, 3]] = 1
    ml[1, 13] = 1
    weak = [_sample(rng, 0, m) for m in ml]
    strong = [dict(w, image=np.clip(w["image"] * 0.8 + 20, 0, 255).astype(np.float32))
              for w in weak]
    return {"label_q": lq, "label_k": lk, "unlabel_q": strong, "unlabel_k": weak}


def _global_draws(per_rank, calls):
    """The ranks' recorded draws in the single process's order: ``calls``
    lists the images a rank of each list of samples in the order the steps
    run them; a list's images come rank by rank."""
    out, pos = [], [0] * len(per_rank)
    for n in calls:
        for r, draws in enumerate(per_rank):
            k = n * DRAWS_PER_IMAGE
            out += draws[pos[r]:pos[r] + k]
            pos[r] += k
    assert all(p == len(d) for p, d in zip(pos, per_rank))
    return out


def _close_update(got, want, before, msg):
    """The change of a weight over the steps within the stated tolerance."""
    tol = 1e-4 * np.abs(want) + 1e-6 * np.abs(want).max() + np.spacing(np.abs(before))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (msg, int(bad.sum()), float(np.abs(got - want)[bad].max()))


def _run_pair(tmp_path, kind, config, batches, start_iter, calls, monkeypatch):
    """The 2-rank run (draws recorded) and the single-process run on the
    same batches and draws; returns both reports and the single trainer."""
    cfg = load_config(config, OPTS)
    model = build_synthetic_frcnn(cfg, "cpu", 0)
    sd = model.state_dict()
    sd["roi_heads.box_predictor.cls_score.bias"][KEPT] += BIAS
    start = {k: v.clone() for k, v in sd.items()}
    spec = tmp_path / "spec.pt"
    torch.save({"kind": kind, "config": config, "opts": OPTS, "model": start,
                "batches": batches, "start_iter": start_iter, "record_draws": True,
                "threads": 1}, spec)
    launch_mod.launch(check_ddp.train_steps, 2, args=(str(spec), str(tmp_path)),
                      backend="gloo", device="cpu")
    r0, r1 = check_ddp.load_reports(str(tmp_path), 2)
    assert r0["ddp"] and r1["ddp"] and r0["world"] == 2
    for a, b in zip(r0["records"], r1["records"]):
        assert a["digest"] == b["digest"]
    draws = _global_draws([r0["draws"], r1["draws"]], calls)
    monkeypatch.setattr(sampling, "uniform", check_ddp.DrawFeeder(draws))
    trainer_cls = BaselineTrainer if kind == "baseline" else UBTeacherTrainer
    data = [b["label_k"] for b in batches] if kind == "baseline" else batches
    single = trainer_cls(cfg, model, iter(data))
    assert single.ddp is None
    single.train(start_iter, start_iter + len(batches))
    assert not sampling.uniform.arrays
    return r0, single, start


def _compare(r0, single, start):
    for key, got in r0["scalars"].items():
        if key == "data_time":
            continue
        want = [v for v, _ in single.storage.histories()[key].values()]
        got = [v for _, v in got]
        if key == "num_pseudo_boxes":
            assert got == want, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=key)
    moved = 0
    for k, v in single.model.state_dict().items():
        if not v.is_floating_point():
            continue
        want = (v - start[k]).numpy()
        got = (r0["model"][k] - start[k]).numpy()
        _close_update(got, want, start[k].numpy(), k)
        moved += int(np.abs(want).max() > 0)
    assert moved > 10
    if r0["teacher"] is not None:
        for k, v in single.teacher.state_dict().items():
            if v.is_floating_point():
                _close_update((r0["teacher"][k] - start[k]).numpy(), (v - start[k]).numpy(),
                              start[k].numpy(), "teacher." + k)


def test_stage2_ddp_steps_match_the_single_process_global_batch(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    batches = [_batch(rng), _batch(rng)]
    r0, single, start = _run_pair(tmp_path, "baseline", BASELINE, batches, 0, [1, 1],
                                  monkeypatch)
    assert len(r0["draws"]) == 2 * DRAWS_PER_IMAGE
    _compare(r0, single, start)


def test_stage3_semisup_steps_match_the_single_process_global_batch(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    batches = [_batch(rng), _batch(rng)]
    burn_up = load_config(SSOD, OPTS).SEMISUPNET.BURN_UP_STEP
    # each step: label_q, label_k (stacked in that order), then unlabel_q
    r0, single, start = _run_pair(tmp_path, "ubteacher", SSOD, batches, burn_up, [1] * 6,
                                  monkeypatch)
    pseudo = [v for v, _ in single.storage.histories()["num_pseudo_boxes"].values()]
    assert all(p > 0 for p in pseudo), pseudo
    _compare(r0, single, start)


@pytest.mark.parametrize("iter_size,resume_at", [(1, 2), (2, 1)])
def test_checkpoint_of_world_two_is_written_once_resumes_and_loads_alone(tmp_path, iter_size,
                                                                        resume_at):
    """Stage1Trainer at world 2 (dropout 0.5, so each rank's generator
    matters), 3 steps of 2 x 1 image with a checkpoint after step
    ``resume_at``; a second trainer from the start weights resumes from it
    and takes the remaining steps: the same bits as the straight run's,
    every rank's generator state included, and with WSL.ITER_SIZE 2 each
    rank's gradient accumulated towards the update (its own until the
    all-reduce). Rank 0 wrote the file, rank 1 none; it loads into a
    trainer of one process (rank 0's generator and gradients)."""
    opts = ["MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64], "TPU.COMPUTE_DTYPE", "float32",
            "TPU.PGT_SEED_CAPACITY", 16, "SOLVER.BASE_LR", 0.01, "MODEL.DEVICE", "cpu",
            "WSL.ITER_SIZE", iter_size]
    cfg = load_config(CONFIG, opts)
    samples = [_stage1_sample(30 + i) for i in range(6)]
    spec = tmp_path / "spec.pt"
    torch.save({"kind": "stage1", "config": CONFIG, "opts": opts, "dan_dropout": 0.5,
                "model": build_synthetic_model(cfg, "cpu", 0).state_dict(), "threads": 1,
                "resume_at": resume_at, "batches": [samples[0:2], samples[2:4], samples[4:6]]},
               spec)
    launch_mod.launch(check_ddp.train_steps, 2, args=(str(spec), str(tmp_path)),
                      backend="gloo", device="cpu")
    r0, r1 = check_ddp.load_reports(str(tmp_path), 2)
    name = f"model_{resume_at - 1:07d}"
    assert r0["saved"] == [name + ".pth"] and r1["saved"] == []
    for r in (r0, r1):
        assert [x["iter"] for x in r["records"]] == [0, 1, 2]
        assert r["resumed"]["start"] == resume_at
        assert r["resumed"]["records"] == [dict(x, ms=y["ms"]) for x, y in
                                           zip(r["records"][resume_at:], r["resumed"]["records"])]
        assert torch.equal(r["resumed"]["generator"], r["generator"])
    assert not torch.equal(r0["generator"], r1["generator"])
    state = Checkpointer(str(tmp_path / "checkpoints")).load(name)
    assert len(state["generators"]) == 2 and torch.equal(state["generator"],
                                                          state["generators"][0])
    pending = state["accumulated"]
    assert pending["micro_steps"] == resume_at % iter_size
    assert (pending.get("rank_grads") is not None) == (iter_size > 1)
    one = Stage1Trainer(cfg, build_synthetic_model(cfg, "cpu", 1), iter(()))
    one.load_state_dict(state)
    assert one.steps_done == resume_at and one.ddp is None
    assert torch.equal(one.generator.get_state(), state["generators"][0])
    model = one.model.state_dict()
    assert all(torch.equal(model[k], v) for k, v in state["model"].items())
