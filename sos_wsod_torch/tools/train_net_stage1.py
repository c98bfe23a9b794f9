"""Stage-1 WSOD training and evaluation CLI.

Counterpart of ``tools/train_net_stage1.py`` (the reference's
train_net_multi.py): setup -> model -> Stage1Trainer with its hooks ->
resume -> train. The model is MultiInputRCNN for that
MODEL.META_ARCHITECTURE and GeneralizedRCNNWSL (the single-view WSDDN, OICR,
PCL, CMIL and ContextLocNet heads, MODEL.ROI_HEADS.NAME) for any other, as
in the JAX CLI; ``--eval-only`` runs the VOC evaluator over each of
DATASETS.TEST, and with WSODEVAL.SAVE_DETECTION_RESULT writes the
detection-result JSON that stage 2 reads. The VOC sets and the extra WSL
sets are registered under ``./datasets`` (``register_all_voc``,
``register_all_extra``). As in the JAX CLI, MODEL.WEIGHTS is
not read: training starts from the model's initializer, seeded by SEED.
``__main__`` starts ``main`` through ``engine/launch.py``: ``--num-gpus N``
processes on this machine (``--num-machines M --machine-rank R --dist-url
tcp://host:port`` across machines), one a GPU, data parallel; each maps its
share of SOLVER.IMS_PER_BATCH.

    python -m sos_wsod_torch.tools.train_net_stage1 [--num-gpus N] \\
        --config-file configs/stage1/voc07_oicr_plus.yaml [--resume] [--eval-only] [KEY VALUE ...]
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict

from ..config import get_cfg
from ..data.build import build_stage1_test_loader, build_stage1_train_loader, rank_and_world
from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.builtin_extra import register_all_extra
from ..data.datasets.voc import register_all_voc
from ..engine.checkpoint import Checkpointer, PeriodicCheckpointer
from ..engine.defaults import (
    auto_scale_workers,
    config_device,
    default_argument_parser,
    default_setup,
    run_stage1_inference,
)
from ..engine.hooks import (
    CheckpointHook,
    EvalHook,
    IterationTimer,
    LRSchedulerHook,
    PeriodicWriter,
)
from ..engine.launch import launch
from ..engine.synthetic import build_synthetic_model
from ..engine.trainer import Stage1Trainer
from ..engine.weights import load_weights
from ..evaluation.testing import verify_results
from ..evaluation.voc_eval import PascalVOCDetectionEvaluator, annotations_from_dataset_dicts
from ..models.meta.rcnn_wsl_single import build_stage1_model
from ..parallel import comm
from ..utils.events import CommonMetricPrinter, JSONWriter

logger = logging.getLogger(__name__)


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    cfg = auto_scale_workers(cfg, rank_and_world()[1])
    default_setup(cfg, args)
    return cfg


def do_test(cfg, model) -> OrderedDict:
    """Each of DATASETS.TEST through ``run_stage1_inference`` into a VOC
    evaluator over its XML ground truth; checks TEST.EXPECTED_RESULTS."""
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
                cfg.OUTPUT_DIR, "detection_results", "oicr_plus_{}.json"))
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
        model = load_weights(build_stage1_model(cfg, device="meta"), state["model"], device)
        logger.info("Loaded the model of %s (iteration %s)", checkpointer.path(name),
                    state.get("iter"))
        results = do_test(cfg, model)
        comm.synchronize()
        return results

    model = build_synthetic_model(cfg, device, max(cfg.SEED, 0))
    trainer = Stage1Trainer(cfg, model, build_stage1_train_loader(cfg))
    # rank 0 prints and writes metrics.json
    writer = PeriodicWriter([CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
                             JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))],
                            period=20) if comm.is_main_process() else None
    trainer.register_hooks([
        IterationTimer(),
        LRSchedulerHook(),
        CheckpointHook(PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD,
                                            cfg.SOLVER.MAX_ITER)),
        EvalHook(cfg.TEST.EVAL_PERIOD, lambda: do_test(cfg, model)),
        writer,
        *hooks,
    ])
    start_iter = checkpointer.resume_or_load(trainer, resume=args.resume)
    try:
        trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    finally:
        trainer.data_iter.close()   # stops the mapper's threads
    return trainer


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url,
           args=(args,), device=config_device(args.config_file, args.opts))
