"""Stage-2/3 evaluation CLI (pseudo-FSOD baseline and Unbiased-Teacher SSOD).

Counterpart of ``tools/train_net_unbias.py`` (the reference's unbias
train_net.py) with ``--eval-only``: the checkpoint named by
``last_checkpoint`` (else ``model_final``) is loaded, its teacher's weights
when SEMISUPNET.EVAL_TEACHER is set and the file holds a teacher, else the
model's, and each of DATASETS.TEST runs through the stage-1 test mapper
(``build_stage1_test_loader``), ``GeneralizedRCNN.predict`` and the VOC
evaluator. With WSODEVAL.SAVE_DETECTION_RESULT the evaluator also writes
its detection-result JSON (to WSODEVAL.SAVE_PATH, else
OUTPUT_DIR/detection_results/frcnn_{dataset}.json). Training raises: it is
the next slice of the port.

    python -m sos_wsod_torch.tools.train_net_unbias \\
        --config-file configs/stage23/voc_baseline.yaml --eval-only [KEY VALUE ...]
"""
from __future__ import annotations

import logging
import os
from collections import OrderedDict

import torch

from ..config import get_cfg
from ..data.build import build_stage1_test_loader
from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.voc import register_all_voc
from ..engine.checkpoint import Checkpointer
from ..engine.defaults import default_argument_parser, default_setup, run_stage1_inference
from ..engine.weights import load_weights
from ..evaluation.testing import verify_results
from ..evaluation.voc_eval import PascalVOCDetectionEvaluator, annotations_from_dataset_dicts
from ..models.meta.rcnn import GeneralizedRCNN

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


def main(args):
    """With ``--eval-only``, evaluate the checkpoint named by
    ``last_checkpoint`` (else ``model_final``); returns the results by
    dataset."""
    cfg = setup(args)
    register_all_voc()
    if not args.eval_only:
        raise NotImplementedError(
            "train_net_unbias: only --eval-only is ported; stage-2/3 training (burn-in, "
            "Unbiased Teacher) is the next slice (ROADMAP Queue 1 item 4)")
    device = torch.device(cfg.MODEL.DEVICE)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    name = checkpointer.get_last_checkpoint() or "model_final"
    state = checkpointer.load(name, map_location=device)
    role = "teacher" if cfg.SEMISUPNET.EVAL_TEACHER and "teacher" in state else "model"
    model = load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), state[role], device)
    logger.info("Loaded the %s of %s (iteration %s)", role, checkpointer.path(name),
                state.get("iter"))
    return do_test(cfg, model)


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
