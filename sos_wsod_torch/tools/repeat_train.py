"""Does training repeat from its seed on the card?

    python -m sos_wsod_torch.tools.repeat_train [--stage 1|2|3] [--steps 4]
        [--deterministic] [--bwd-source OLD_BWD.cu]

``--stage 1`` (the default) runs the full-width training slice that
``chip_smoke.py`` drives (``configs/stage1/voc07_oicr_plus.yaml`` with
random weights from a seed, ``SOLVER.IMS_PER_BATCH 1``, synthetic 375x500
images with 4000 proposals through the real mapper and ``Stage1Trainer``)
twice from the same seed in this process. ``--stage 2`` runs the stage-2
burn-in step that ``chip_smoke.py``'s phase 11 drives
(``configs/stage23/voc_baseline.yaml`` at full width with random weights
from the seed, 2 labeled and 2 unlabeled images a step as phase 11 cuts it,
on a synthetic VOC tree with pseudo labels and the dataseed in a temporary
directory, through the two-crop loader and ``UBTeacherTrainer``) twice the
same way. ``--stage 3`` runs phase 12's stage-3 training: the same tree, a
stage-2 checkpoint from the seed, the dataseed the split tool
(``tools/splits.py``, ``configs/stage23/voc_split.yaml``) writes from it
with half the train+val images labeled, then ``configs/stage23/voc_ssod.yaml``
with 2 + 2 images a step: one burn-in step, then semi-supervised steps
with the EMA teacher. It prints each step's losses of both runs
(``loss_cls`` and ``total_loss``; stage 2 also the box and RPN losses,
stage 3 also the pseudo-supervised ones and ``num_pseudo_boxes``), whether
each pair is equal bit for bit, and whether the trained weights of both
runs are (stage 3: the student's and the teacher's). ``--deterministic`` runs both under
``torch.use_deterministic_algorithms(True, warn_only=True)`` with cuDNN's
deterministic algorithms and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, and lists
the operations that warned they have no deterministic implementation: what
is left to make a run repeat. ``--bwd-source`` runs the stage's backward
kernel (ROIPool for stage 1, ROIAlign for stages 2 and 3) built from another source
(an earlier version, e.g. the f32 atomics, through the adapter of
``bench_roi_pool.py`` or ``bench_roi_align.py``) in place of the current
one, to tell its share. The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import warnings
from typing import Dict, List, Optional, Sequence

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml"
RAW_HW, NUM_PROPOSALS, SEED = (375, 500), 4000, 0
WATCH = ("roi_heads.dan.fc1.weight", "roi_heads.box_refinery_2.cls_score.weight",
         "backbone.plain5.conv3.weight")
STAGE2_CONFIG = ROOT / "configs" / "stage23" / "voc_baseline.yaml"
STAGE2_CUT = ["SOLVER.IMG_PER_BATCH_LABEL", 2, "SOLVER.IMG_PER_BATCH_UNLABEL", 2]   # phase 11's
STAGE2_SPLITS = (("train", 8), ("val", 4), ("test", 2))
STAGE2_LOSSES = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss")
STAGE2_WATCH = ("roi_heads.box_predictor.cls_score.weight", "roi_heads.box_head.fc1.weight",
                "proposal_generator.head.conv.weight", "backbone.fpn.fpn_output2.weight",
                "backbone.bottom_up.res5_block0.conv1.weight")
STAGE3_CONFIG = ROOT / "configs" / "stage23" / "voc_ssod.yaml"
SPLIT_CONFIG = ROOT / "configs" / "stage23" / "voc_split.yaml"
STAGE3_LOSSES = STAGE2_LOSSES + ("loss_cls_pseudo", "loss_box_reg_pseudo", "loss_rpn_cls_pseudo",
                                 "loss_rpn_loc_pseudo", "num_pseudo_boxes")


def train_once(device, steps: int, opts: Sequence = (), raw_hw=RAW_HW,
               num_proposals: int = NUM_PROPOSALS) -> Dict[str, object]:
    """One training run from the seed: per-step scalars and the watched
    weights after the last step. ``opts`` are config overrides (a small
    width for a run on the CPU)."""
    from sos_wsod_torch.data.build import batched_stream
    from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_model, load_config, synthetic_train_dicts)
    from sos_wsod_torch.engine.trainer import Stage1Trainer

    cfg = load_config(str(CONFIG), ["SOLVER.IMS_PER_BATCH", 1, *opts])
    model = build_synthetic_model(cfg, device, SEED)
    dicts = synthetic_train_dicts(steps, raw_hw, num_proposals,
                                  cfg.MODEL.ROI_HEADS.NUM_CLASSES, SEED)
    stream = batched_stream(
        dicts, DatasetMapperMultiInput.from_cfg(cfg), cfg.SOLVER.IMS_PER_BATCH,
        seed=max(cfg.SEED, 0), size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING)
    trainer = Stage1Trainer(cfg, model, stream)
    trainer.train(0, steps)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    stream.close()
    hist = trainer.storage.histories()
    params = dict(model.named_parameters())
    return {"loss_cls": [v for v, _ in hist["loss_cls"].values()],
            "total_loss": [v for v, _ in hist["total_loss"].values()],
            "weights": {n: params[n].detach().clone() for n in WATCH},
            "ddp": trainer.ddp is not None}


def train_stage2_once(device, steps: int, opts: Sequence = (), raw_hw=RAW_HW,
                      num_proposals: int = 8) -> Dict[str, object]:
    """One stage-2 burn-in run from the seed on a synthetic VOC tree written
    into a temporary directory (the working directory while it trains):
    per-step losses and the watched weights after the last step. ``opts``
    are config overrides (a small width for a run on the CPU)."""
    from sos_wsod_torch.data.datasets.voc import register_all_voc
    from sos_wsod_torch.data.mapper_twocrop import build_semisup_loader_from_cfg
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_frcnn, load_config, write_dataseed, write_pseudo_labels,
        write_synthetic_voc)
    from sos_wsod_torch.engine.ubteacher import UBTeacherTrainer

    cfg = load_config(str(STAGE2_CONFIG), [*STAGE2_CUT, "SOLVER.MAX_ITER", steps, *opts])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_voc(tmp, STAGE2_SPLITS, raw_hw, num_proposals, SEED)
        write_pseudo_labels(tmp, [split for split, _ in STAGE2_SPLITS if split != "test"])
        write_dataseed(tmp, cfg, sum(n for split, n in STAGE2_SPLITS if split != "test"))
        os.chdir(tmp)
        try:
            register_all_voc()
            model = build_synthetic_frcnn(cfg, device, max(cfg.SEED, 0))
            trainer = UBTeacherTrainer(cfg, model, build_semisup_loader_from_cfg(cfg))
            trainer.train(0, steps)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
    hist = trainer.storage.histories()
    params = dict(model.named_parameters())
    return {**{k: [v for v, _ in hist[k].values()] for k in STAGE2_LOSSES},
            "weights": {n: params[n].detach().clone() for n in STAGE2_WATCH},
            "ddp": trainer.ddp is not None}


def write_stage3_inputs(root: str, opts: Sequence = (), raw_hw=RAW_HW,
                        num_proposals: int = 8) -> List[str]:
    """What stage-3 training reads, written under ``root``: the synthetic
    VOC tree of STAGE2_SPLITS with pseudo labels, a stage-2 checkpoint from
    the seed (``output_stage2/model_final``), and the dataseed
    (``dataseed/split.txt``) that the split tool writes from it, run in this
    process with ``--k`` half the train+val images. ``opts`` are config
    overrides of both the split and the training (a small width for a run on
    the CPU). Returns the overrides that point voc_ssod at that dataseed."""
    from sos_wsod_torch.engine.synthetic import (
        load_config, write_pseudo_labels, write_stage2_checkpoint, write_synthetic_voc)
    from sos_wsod_torch.tools import splits

    write_synthetic_voc(root, STAGE2_SPLITS, raw_hw, num_proposals, SEED)
    write_pseudo_labels(root, [split for split, _ in STAGE2_SPLITS if split != "test"])
    write_stage2_checkpoint(os.path.join(root, "output_stage2"),
                            load_config(str(SPLIT_CONFIG), opts), SEED)
    n_train = sum(n for split, n in STAGE2_SPLITS if split != "test")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _, percent = splits.main(["--config", str(SPLIT_CONFIG), "--ckpt",
                                  "output_stage2/model_final", "--save-path", "dataseed/split.txt",
                                  "--k", str(n_train // 2), *(str(o) for o in opts)])
    finally:
        os.chdir(cwd)
    return ["DATALOADER.SUP_PERCENT", str(percent), "DATALOADER.RANDOM_DATA_SEED_PATH",
            "dataseed/split.txt"]


def train_stage3_once(device, steps: int, opts: Sequence = (), raw_hw=RAW_HW,
                      num_proposals: int = 8) -> Dict[str, object]:
    """One stage-3 run from the seed (``write_stage3_inputs`` in a temporary
    directory, the working directory while it trains): per-step losses and
    ``num_pseudo_boxes``, and the watched weights of the student and the
    teacher after the last step."""
    from sos_wsod_torch.data.datasets.voc import register_all_voc
    from sos_wsod_torch.data.mapper_twocrop import build_semisup_loader_from_cfg
    from sos_wsod_torch.engine.synthetic import build_synthetic_frcnn, load_config
    from sos_wsod_torch.engine.ubteacher import UBTeacherTrainer

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        seed_opts = write_stage3_inputs(tmp, opts, raw_hw, num_proposals)
        cfg = load_config(str(STAGE3_CONFIG), [*STAGE2_CUT, "SOLVER.MAX_ITER", steps, *opts,
                                               *seed_opts])
        os.chdir(tmp)
        try:
            register_all_voc()
            model = build_synthetic_frcnn(cfg, device, max(cfg.SEED, 0))
            trainer = UBTeacherTrainer(cfg, model, build_semisup_loader_from_cfg(cfg))
            trainer.train(0, steps)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
    hist = trainer.storage.histories()
    student, teacher = dict(model.named_parameters()), trainer.teacher.state_dict()
    # per step; None where a step has no such scalar (the burn-in's pseudo terms)
    by_step = {k: dict((it, v) for v, it in hist[k].values()) if k in hist else {}
               for k in STAGE3_LOSSES}
    return {**{k: [by_step[k].get(step) for step in range(steps)] for k in STAGE3_LOSSES},
            "weights": {**{n: student[n].detach().clone() for n in STAGE2_WATCH},
                        **{f"teacher.{n}": teacher[n].clone() for n in STAGE2_WATCH}}}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", type=int, choices=(1, 2, 3), default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--deterministic", action="store_true",
                    help="run both trainings with deterministic algorithms")
    ap.add_argument("--bwd-source", default=None,
                    help="a backward source (ROIPool for stage 1, ROIAlign for stages 2-3) to "
                         "run "
                         "in place of the current kernel")
    return ap.parse_args(argv)


def use_bwd_source(path: str, stage: int = 1) -> None:
    """Route the stage's autograd Function's backward to a build of ``path``."""
    if stage in (2, 3):
        from sos_wsod_torch.ops import roi_align as ops
        from sos_wsod_torch.tools import bench_roi_align as bench

        fn, _ = bench.bwd_builds([f"other={path}"])["other"]
        ops.roi_align_bwd_cuda = fn
        return
    from sos_wsod_torch.ops import roi_pool as ops
    from sos_wsod_torch.tools import bench_roi_pool as bench

    builds = bench.bwd_builds(bench.parse_args(["--bwd-baseline", f"other={path}"]))
    fn, _ = builds["other"]
    ops.roi_pool_bwd_cuda = fn


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("repeat_train needs a CUDA device")
    if args.deterministic:   # read when cuBLAS makes its handle: before any CUDA work
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    if args.bwd_source:
        use_bwd_source(args.bwd_source, args.stage)
    once, keys = {1: (train_once, ("loss_cls", "total_loss")),
                  2: (train_stage2_once, STAGE2_LOSSES),
                  3: (train_stage3_once, STAGE3_LOSSES)}[args.stage]
    runs: List[dict] = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            runs.append(once(device, args.steps))
    a, b = runs
    for step in range(args.steps):
        print(f"step {step}: " + "; ".join(
            f"{k} {a[k][step]!r} / {b[k][step]!r} "
            f"{'same' if a[k][step] == b[k][step] else 'DIFFER'}" for k in keys), flush=True)
    same_w = {n: torch.equal(a["weights"][n], b["weights"][n]) for n in a["weights"]}
    print(f"trained weights bit-identical: {same_w}", flush=True)
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "does not have a deterministic implementation" in str(w.message)})
    if args.deterministic:
        print(f"operations without a deterministic implementation: {nondet or 'none'}",
              flush=True)
    summary = {"stage": args.stage, "deterministic": args.deterministic,
               "bwd_source": args.bwd_source, "steps": args.steps,
               "losses_equal": all(a[k] == b[k] for k in keys),
               "loss_cls_equal": a["loss_cls"] == b["loss_cls"],
               "total_loss_equal": a["total_loss"] == b["total_loss"],
               f"step{args.steps - 1}_loss_cls": [a["loss_cls"][-1], b["loss_cls"][-1]],
               "weights_equal": all(same_w.values()), "nondeterministic_ops": nondet}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
