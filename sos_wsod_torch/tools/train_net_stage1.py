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
share of SOLVER.IMS_PER_BATCH. With TPU.MODEL_AXIS_SIZE tp > 1 the world
is dp x tp: the DAN fc stack is split over groups of tp ranks
(``parallel/tensor.py``), which share their images, and SOLVER.IMS_PER_BATCH
must divide by dp, as in the JAX CLI; evaluation during training then runs
on every rank, each tensor-parallel group over its dp share of the test
images. A world of one ignores the key, as the JAX CLI does on one chip.

    python -m sos_wsod_torch.tools.train_net_stage1 [--num-gpus N] \\
        --config-file configs/stage1/voc07_oicr_plus.yaml [--resume] [--eval-only] \\
        [TPU.MODEL_AXIS_SIZE tp] [KEY VALUE ...]
"""
from __future__ import annotations

import itertools
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
    inference_on_samples,
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
from ..parallel import comm, tensor
from ..utils.events import CommonMetricPrinter, JSONWriter

logger = logging.getLogger(__name__)


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    tensor.init(cfg.TPU.MODEL_AXIS_SIZE)
    cfg = auto_scale_workers(cfg, rank_and_world()[1])
    default_setup(cfg, args)
    return cfg


class _Recorder:
    """Stands in for an evaluator: keeps the arguments of each
    ``process_single``."""

    def __init__(self):
        self.items = []

    def process_single(self, *args) -> None:
        self.items.append(args)


def _infer_split(cfg, model, name: str, evaluator, device) -> OrderedDict:
    """``run_stage1_inference`` of a model split over tensor-parallel
    groups, called on every rank: each group infers the images of its
    data-parallel share, rank 0 hands the detections to ``evaluator`` in
    dataset order and returns its results; the other ranks return {}."""
    dp_rank, dp = rank_and_world()
    recorder = _Recorder()
    inference_on_samples(model, build_stage1_test_loader(cfg, name, shard=(dp_rank, dp)),
                         recorder, device)
    shares = comm.process_gather([recorder.items])[::tensor.size()]
    if not comm.is_main_process():
        return OrderedDict()
    evaluator.reset()
    for item in itertools.chain.from_iterable(itertools.zip_longest(*shares)):
        if item is not None:
            evaluator.process_single(*item)
    results = evaluator.evaluate()
    logger.info("Evaluation results: %s", dict(results))
    return results


def do_test(cfg, model, split: bool = False) -> OrderedDict:
    """Each of DATASETS.TEST through ``run_stage1_inference`` into a VOC
    evaluator over its XML ground truth; checks TEST.EXPECTED_RESULTS. A
    model split over tensor-parallel groups (``split``) is evaluated by
    every rank (``_infer_split``); rank 0 returns the results."""
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
        if split:
            results[name] = _infer_split(cfg, model, name, evaluator, device)
        else:
            results[name] = run_stage1_inference(model, build_stage1_test_loader(cfg, name),
                                                 evaluator, device)
    if split and not comm.is_main_process():
        return OrderedDict()
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

    dp, tp = rank_and_world()[1], tensor.size()
    if cfg.SOLVER.IMS_PER_BATCH % dp:
        raise ValueError(f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH} not divisible by "
                         f"data-parallel size {dp} ({comm.get_world_size()} processes / "
                         f"MODEL_AXIS_SIZE {tp})")
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
        EvalHook(cfg.TEST.EVAL_PERIOD, lambda: do_test(cfg, model, split=tp > 1),
                 all_ranks=tp > 1),
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
