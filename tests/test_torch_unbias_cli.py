"""The port's stage-2/3 entry point (sos_wsod_torch/tools/train_net_unbias.py):
--eval-only against the JAX CLI's do_test (tools/train_net_unbias.py) on a
synthetic VOC tree (engine/synthetic.py:write_synthetic_voc, one image
shape), with the same weights; the detectron2 weight mapping
(engine/weights.py:state_dict_from_d2_frcnn) against the JAX package's
frcnn_param_tree; and training through the CLI on the CPU (two steps, a
checkpoint with the model and the teacher, --resume, --eval-only on it;
voc_ssod's burn-in and first semi-supervised step), whose steps are held
against the JAX package's in tests/test_torch_frcnn_train.py and
tests/test_torch_ssod.py.

Both CLIs run the same random R50-FPN weights (engine/synthetic.py:
random_d2_frcnn_state_dict, at tiny widths: ResNet depth 14, FPN 32
channels, fc 64, pre/post-NMS top-k 64/32) in f32 through the same test
mapper and the same VOC evaluator, which rounds scores to 3 decimals and
coordinates to 1. The detections it records and the AP it computes are held
equal exactly. The weight mapping is exact.
"""
from __future__ import annotations

import logging
import pathlib

import numpy as np
import pytest
import torch

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.engine.weights import frcnn_param_tree
from sos_wsod_tpu.evaluation.voc_eval import PascalVOCDetectionEvaluator as JaxEvaluator
from sos_wsod_tpu.models.meta.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from sos_wsod_torch.engine.checkpoint import Checkpointer
from sos_wsod_torch.engine.defaults import default_argument_parser
from sos_wsod_torch.engine.synthetic import (
    load_config,
    random_d2_frcnn_state_dict,
    write_dataseed,
    write_pseudo_labels,
    write_stage2_checkpoint,
    write_synthetic_voc,
)
from sos_wsod_torch.engine.weights import state_dict_from_d2_frcnn, state_dict_from_flax
from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator
from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN
from sos_wsod_torch.tools import train_net_unbias as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = str(ROOT / "configs" / "stage23" / "voc_baseline.yaml")
SSOD = str(ROOT / "configs" / "stage23" / "voc_ssod.yaml")
TINY = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "14", "MODEL.FPN.OUT_CHANNELS",
        "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
        "MODEL.RPN.POST_NMS_TOPK_TEST", "32", "INPUT.MIN_SIZE_TEST", "48"]
# training at the same widths: 2 + 2 images a step on 40-48 px short sides
TRAIN = TINY + ["MODEL.DEVICE", "cpu", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
                "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE",
                "32", "INPUT.MIN_SIZE_TRAIN", "(40, 48)", "INPUT.MAX_SIZE_TRAIN", "80",
                "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
                "TPU.PGT_CAPACITY", "8", "SOLVER.CHECKPOINT_PERIOD", "1"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc2")
    write_synthetic_voc(str(root), (("test", 3),), (60, 80), 30, seed=0)
    return root


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """voc_baseline's DATASETS.TRAIN (the _wsl sets of train and val, with
    their pseudo labels), its dataseed, and a test split."""
    root = tmp_path_factory.mktemp("voc2_train")
    write_synthetic_voc(str(root), (("train", 3), ("val", 2), ("test", 2)), (60, 80), 30, seed=1)
    write_pseudo_labels(str(root))
    write_dataseed(str(root), load_config(BASELINE), 5)
    return root


def _tiny_cfg(config=BASELINE):
    return load_config(config, TINY + ["MODEL.DEVICE", "cpu"])


def test_d2_frcnn_mapping_matches_jax_tree():
    """Every key of the port's model, from a detectron2 state dict, equal to
    the JAX tree's mapping carried over by state_dict_from_flax; an
    ubteacher ensemble splits into student and teacher."""
    cfg = _tiny_cfg()
    sd = random_d2_frcnn_state_dict(cfg, seed=3)
    ours = state_dict_from_d2_frcnn(sd)
    theirs = state_dict_from_flax(frcnn_param_tree(sd))
    assert set(ours) == set(theirs) == set(GeneralizedRCNN.from_cfg(cfg, device="meta")
                                           .state_dict())
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    teacher = random_d2_frcnn_state_dict(cfg, seed=4)
    ens = {**{f"modelStudent.{k}": v for k, v in sd.items()},
           **{f"modelTeacher.{k}": v for k, v in teacher.items()},
           "modelStudent.pixel_mean": np.zeros((3, 1, 1), np.float32)}
    for role, want in (("student", ours), ("teacher", state_dict_from_d2_frcnn(teacher))):
        got = state_dict_from_d2_frcnn(ens, role)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
    with pytest.raises(ValueError, match="teacher"):
        state_dict_from_d2_frcnn(sd, "teacher")


def _capture(monkeypatch, cls):
    """Record each evaluator's rounded detections when it evaluates."""
    seen = []
    evaluate = cls.evaluate

    def wrapped(self):
        seen.append({c: sorted(v) for c, v in self._predictions.items()})
        return evaluate(self)

    monkeypatch.setattr(cls, "evaluate", wrapped)
    return seen


def test_eval_only_matches_jax_do_test(tree, monkeypatch):
    """The same weights through the JAX CLI's do_test and the port's
    --eval-only (the checkpoint's "model", EVAL_TEACHER being off in
    voc_baseline): the same rounded detections and the same AP."""
    from tools import train_net_unbias as jax_cli

    monkeypatch.chdir(tree)
    cfg = _tiny_cfg()
    write_stage2_checkpoint("out", cfg, seed=0, iteration=7)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(BASELINE)
    jcfg.merge_from_list(list(TINY))
    jm = JaxGeneralizedRCNN.from_cfg(jcfg)
    jax_seen = _capture(monkeypatch, JaxEvaluator)
    want = jax_cli.do_test(jcfg, jm, frcnn_param_tree(random_d2_frcnn_state_dict(cfg, 0)))

    seen = _capture(monkeypatch, PascalVOCDetectionEvaluator)
    got = cli.main(default_argument_parser().parse_args(
        ["--config-file", BASELINE, "--eval-only", *TINY, "MODEL.DEVICE", "cpu",
         "OUTPUT_DIR", "out"]))
    assert got == want
    assert seen == jax_seen and sum(len(v) for v in seen[0].values()) > 0
    assert np.isfinite(got["voc_2007_test"]["bbox"]["AP50"])


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_eval_only_picks_the_teacher_and_writes_json(tree, monkeypatch):
    """voc_ssod sets EVAL_TEACHER: the checkpoint's "teacher" is evaluated;
    with WSODEVAL.SAVE_DETECTION_RESULT the detection JSON is written."""
    monkeypatch.chdir(tree)
    write_stage2_checkpoint("ssod", _tiny_cfg(SSOD), seed=0)
    records = _Records()
    logging.getLogger(cli.__name__).addHandler(records)
    try:
        res = cli.main(default_argument_parser().parse_args(
            ["--config-file", SSOD, "--eval-only", *TINY, "MODEL.DEVICE", "cpu",
             "OUTPUT_DIR", "ssod", "WSODEVAL.SAVE_DETECTION_RESULT", "True"]))
    finally:
        logging.getLogger(cli.__name__).removeHandler(records)
    loaded = [m for m in records.messages if m.startswith("Loaded")]
    assert len(loaded) == 1 and loaded[0].startswith("Loaded the teacher of")
    assert (tree / "ssod" / "detection_results" / "frcnn_voc_2007_test.json").is_file()
    assert set(res) == {"voc_2007_test"}
    state = Checkpointer(str(tree / "ssod")).load("model_final")
    assert set(state) == {"model", "teacher", "iter"}


def _train(*flags_and_opts):
    return cli.main(default_argument_parser().parse_args(
        ["--config-file", BASELINE, *flags_and_opts]))


def test_training_is_refused(train_tree, monkeypatch):
    """What stage-2/3 training refuses: more than one GPU asked of main
    called without engine.launch (which starts the processes of data
    parallelism; tests/test_torch_ddp_ssod.py trains them). The ubteacher
    trainer past its burn-in, once refused too, now trains: voc_ssod through
    the CLI, 1 burn-in step and 1 semi-supervised step; the checkpoint's
    teacher is the student after the burn-in step (the copy at
    BURN_UP_STEP), not the model as built."""
    monkeypatch.chdir(train_tree)
    with pytest.raises(RuntimeError, match="no process group"):
        _train("--num-gpus", "2", *TRAIN, "OUTPUT_DIR", "refused")
    write_dataseed(str(train_tree), load_config(SSOD), 5)
    trainer = cli.main(default_argument_parser().parse_args(
        ["--config-file", SSOD, *TRAIN, "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", "ssod_train"]))
    assert (trainer.burn_up_step, trainer.iter) == (1, 2)
    hist = trainer.storage.histories()
    for k in ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss"):
        assert len(hist[k].values()) == 2 and np.isfinite(hist[k].latest), k
    for k in ("loss_cls_pseudo", "loss_box_reg_pseudo", "loss_rpn_cls_pseudo",
              "loss_rpn_loc_pseudo", "num_pseudo_boxes"):
        assert len(hist[k].values()) == 1 and np.isfinite(hist[k].latest), k
    ckpt = Checkpointer(str(train_tree / "ssod_train"))
    state, burnt = ckpt.load("model_final"), ckpt.load("model_0000000")["model"]
    init = state_dict_from_d2_frcnn(random_d2_frcnn_state_dict(_tiny_cfg(SSOD), 0))
    assert set(state["teacher"]) == set(init) == set(burnt)
    assert all(torch.equal(state["teacher"][k], burnt[k]) for k in burnt)
    name = "roi_heads.box_head.fc1.weight"
    assert not torch.equal(state["teacher"][name], init[name])
    assert not torch.equal(state["model"][name], state["teacher"][name])


def test_cli_trains_resumes_and_evaluates(train_tree, monkeypatch):
    """Two burn-in steps through the CLI: finite losses, a checkpoint each
    step holding the model, its teacher (the weights it started from),
    optimizer, schedule, generator and iteration, and an eval at the end;
    --resume continues to step 3 from model_final; --eval-only loads that
    checkpoint, strictly."""
    monkeypatch.chdir(train_tree)
    trainer = _train(*TRAIN, "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", "out")
    hist = trainer.storage.histories()
    for k in ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss"):
        assert len(hist[k].values()) == 2 and np.isfinite(hist[k].latest), k
    assert "voc_2007_test/bbox/AP50" in hist
    out = train_tree / "out"
    assert {"model_0000000.pth", "model_0000001.pth", "model_final.pth", "last_checkpoint",
            "metrics.json"} <= {p.name for p in out.iterdir()}
    state = Checkpointer(str(out)).load("model_final")
    assert set(state) == {"model", "teacher", "optimizer", "scheduler", "generator", "iter"}
    assert state["iter"] == 2
    cfg = _tiny_cfg()
    start = GeneralizedRCNN.from_cfg(cfg, device="meta").state_dict()
    assert set(state["teacher"]) == set(state["model"]) == set(start)
    init = state_dict_from_d2_frcnn(random_d2_frcnn_state_dict(cfg, 0))
    assert all(torch.equal(state["teacher"][k], init[k]) for k in init)
    assert not torch.equal(state["model"]["roi_heads.box_head.fc1.weight"],
                           init["roi_heads.box_head.fc1.weight"])

    resumed = _train("--resume", *TRAIN, "SOLVER.MAX_ITER", "3", "OUTPUT_DIR", "out")
    assert (resumed.start_iter, resumed.iter) == (2, 3)
    assert Checkpointer(str(out)).load("model_final")["iter"] == 3

    records = _Records()
    logging.getLogger(cli.__name__).addHandler(records)
    try:
        res = _train("--eval-only", *TRAIN, "OUTPUT_DIR", "out")
    finally:
        logging.getLogger(cli.__name__).removeHandler(records)
    loaded = [m for m in records.messages if m.startswith("Loaded")]
    assert len(loaded) == 1 and loaded[0].startswith("Loaded the model of")
    assert loaded[0].endswith("model_final.pth (iteration 3)")
    assert np.isfinite(res["voc_2007_test"]["bbox"]["AP50"])
