"""Stage-2/3 training and evaluation CLI (pseudo-FSOD baseline and
Unbiased-Teacher SSOD).

Counterpart of ``tools/train_net_unbias.py`` (the reference's unbias
train_net.py):
  - training: the trainer by SEMISUPNET.Trainer ("ubteacher":
    ``UBTeacherTrainer`` on the two-crop loader's batches; else
    ``BaselineTrainer`` on its labeled weak stream), the LR schedule of
    ``solver/build.py`` stepped with SGD, and the hooks IterationTimer,
    LRSchedulerHook, CheckpointHook (PeriodicCheckpointer every
    SOLVER.CHECKPOINT_PERIOD steps and at the end), EvalHook (``do_test`` on
    the teacher when SEMISUPNET.EVAL_TEACHER is set and the trainer has one,
    else on the model) and PeriodicWriter; ``--resume`` continues from
    ``last_checkpoint``. As in the JAX CLI, MODEL.WEIGHTS is not read:
    training starts from the seeded initializer (``engine/synthetic.py``,
    SEED). The ubteacher trainer runs its burn-in below
    SEMISUPNET.BURN_UP_STEP and the semi-supervised step (EMA teacher,
    pseudo labels) from there on. ``__main__`` starts ``main`` through
    ``engine/launch.py``: ``--num-gpus N`` processes on this machine
    (``--num-machines M --machine-rank R --dist-url tcp://host:port`` across
    machines), one a GPU, data parallel; each maps its share of
    SOLVER.IMG_PER_BATCH_LABEL / _UNLABEL;
  - ``--eval-only``: the checkpoint named by ``last_checkpoint`` (else
    ``model_final``) is loaded, its teacher's weights when
    SEMISUPNET.EVAL_TEACHER is set and the file holds a teacher, else the
    model's, and each of DATASETS.TEST runs through the stage-1 test mapper
    (``build_stage1_test_loader``), ``GeneralizedRCNN.predict`` and the VOC
    evaluator. With WSODEVAL.SAVE_DETECTION_RESULT the evaluator also writes
    its detection-result JSON (to WSODEVAL.SAVE_PATH, else
    OUTPUT_DIR/detection_results/frcnn_{dataset}.json).

    python -m sos_wsod_torch.tools.train_net_unbias [--num-gpus N] \\
        --config-file configs/stage23/voc_ssod.yaml [--resume] [--eval-only] [KEY VALUE ...]
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict

from ..config import get_cfg
from ..data.build import build_stage1_test_loader
from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.builtin_extra import register_all_extra
from ..data.datasets.voc import register_all_voc
from ..data.mapper_twocrop import build_semisup_loader_from_cfg
from ..engine.checkpoint import Checkpointer, PeriodicCheckpointer
from ..engine.defaults import (
    config_device,
    default_argument_parser,
    default_setup,
    run_stage1_inference,
)
from ..engine.hooks import CheckpointHook, EvalHook, IterationTimer, LRSchedulerHook, PeriodicWriter
from ..engine.launch import launch
from ..engine.synthetic import build_synthetic_frcnn
from ..engine.ubteacher import BaselineTrainer, UBTeacherTrainer
from ..engine.weights import load_weights
from ..evaluation.testing import verify_results
from ..evaluation.voc_eval import PascalVOCDetectionEvaluator, annotations_from_dataset_dicts
from ..models.meta.rcnn import GeneralizedRCNN
from ..parallel import comm
from ..utils.events import CommonMetricPrinter, JSONWriter

logger = logging.getLogger(__name__)


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def do_test(cfg, model) -> OrderedDict:
    """Each of DATASETS.TEST through the test mapper and ``model.predict``
    into a VOC evaluator over its XML ground truth; checks
    TEST.EXPECTED_RESULTS."""
    register_all_voc()
    register_all_extra()
    device = next(model.parameters()).device
    results = OrderedDict()
    for name in cfg.DATASETS.TEST:
        meta = MetadataCatalog.get(name)
        evaluator = PascalVOCDetectionEvaluator(
            name, annotations_from_dataset_dicts(DatasetCatalog.get(name), meta.get("dirname")),
            meta.thing_classes, year=int(meta.get("year", 2007)),
            save_detection_result=cfg.WSODEVAL.SAVE_DETECTION_RESULT,
            save_path=cfg.WSODEVAL.SAVE_PATH or os.path.join(
                cfg.OUTPUT_DIR, "detection_results", "frcnn_{}.json"))
        results[name] = run_stage1_inference(model, build_stage1_test_loader(cfg, name),
                                             evaluator, device)
    if cfg.TEST.EXPECTED_RESULTS:
        verify_results(cfg, results)
    return results


def main(args, hooks=()):
    """Train (returns the trainer) or, with ``--eval-only``, evaluate the
    checkpoint named by ``last_checkpoint``, else ``model_final`` (returns
    the results by dataset; in a process group rank 0 evaluates and the
    others return an empty dict). ``hooks`` are registered after the CLI's
    own. MODEL.DEVICE "cuda" is the card the launcher gave this process."""
    cfg = setup(args)
    register_all_voc()
    register_all_extra()
    device = comm.local_device(cfg.MODEL.DEVICE)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)

    if args.eval_only:
        if not comm.is_main_process():
            comm.synchronize()
            return OrderedDict()
        name = checkpointer.get_last_checkpoint() or "model_final"
        state = checkpointer.load(name, map_location=device)
        role = "teacher" if cfg.SEMISUPNET.EVAL_TEACHER and "teacher" in state else "model"
        model = load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), state[role], device)
        logger.info("Loaded the %s of %s (iteration %s)", role, checkpointer.path(name),
                    state.get("iter"))
        results = do_test(cfg, model)
        comm.synchronize()
        return results

    model = build_synthetic_frcnn(cfg, device, max(cfg.SEED, 0))
    data_iter = build_semisup_loader_from_cfg(cfg)
    if cfg.SEMISUPNET.Trainer == "ubteacher":
        trainer = UBTeacherTrainer(cfg, model, data_iter)
    else:
        trainer = BaselineTrainer(cfg, model, (batch["label_k"] for batch in data_iter))
    # rank 0 prints and writes metrics.json
    writer = PeriodicWriter([CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
                             JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))],
                            period=20) if comm.is_main_process() else None
    trainer.register_hooks([
        IterationTimer(),
        LRSchedulerHook(),
        CheckpointHook(PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD,
                                            cfg.SOLVER.MAX_ITER)),
        EvalHook(cfg.TEST.EVAL_PERIOD, lambda: do_test(cfg, trainer.eval_model())),
        writer,
        *hooks,
    ])
    start_iter = checkpointer.resume_or_load(trainer, resume=args.resume)
    trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    return trainer


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url,
           args=(args,), device=config_device(args.config_file, args.opts))
