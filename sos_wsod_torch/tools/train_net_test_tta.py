"""Test-time-augmentation evaluation CLI.

Counterpart of the top-level ``tools/train_net_test_tta.py`` (ubteacher's
train_net_test_tta.py for stages 2-3, and the WSL TTA wrappers of stage 1):
each image of DATASETS.TEST runs through the model once a view of
TEST.AUG.{MIN_SIZES, MAX_SIZE, FLIP} (``models/tta.py``), and the merged
detections, in the image's coordinates, go to the VOC evaluator.
  - stage 1 (``MultiInputRCNN``): ``--strategy avg`` (the default) averages
    each proposal's scores and class boxes over the views, then runs the one
    ``fast_rcnn_inference_single`` (on the model's device); ``union`` merges
    each view's detections with one NMS on the host;
  - stages 2-3 (``GeneralizedRCNN``): the union of each view's detections.
The views run on MODEL.DEVICE ("cuda" by default) in inference mode, with
bfloat16 autocast when TPU.COMPUTE_DTYPE is bfloat16. The weights come from
the checkpoint ``--ckpt`` (a path relative to OUTPUT_DIR, or absolute; else
the one named by ``last_checkpoint`` in OUTPUT_DIR, else ``model_final``):
its "teacher" when SEMISUPNET.EVAL_TEACHER is set and it holds one, else
its "model". TEST.EXPECTED_RESULTS is checked when set.

    python -m sos_wsod_torch.tools.train_net_test_tta \\
        --config-file configs/stage23/voc07_tta_test.yaml [--strategy auto|avg|union] \\
        [--ckpt FILE] [KEY VALUE ...]
"""
from __future__ import annotations

import contextlib
import logging
from collections import OrderedDict

import numpy as np
import torch
from torch.profiler import record_function

from ..config import get_cfg
from ..data.build import get_detection_dataset_dicts
from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.voc import register_all_voc
from ..data.mapper_multi import read_image_bgr
from ..engine.checkpoint import Checkpointer
from ..engine.defaults import default_argument_parser, default_setup
from ..engine.weights import load_weights
from ..evaluation.testing import verify_results
from ..evaluation.voc_eval import PascalVOCDetectionEvaluator, annotations_from_dataset_dicts
from ..models.meta.rcnn import GeneralizedRCNN
from ..models.meta.rcnn_wsl import MultiInputRCNN
from ..models.postprocess import fast_rcnn_inference_single
from ..models.tta import tta_avg_scores, tta_union_detections

logger = logging.getLogger(__name__)

WSL_ARCHS = ("MultiInputRCNN", "GeneralizedRCNNWSL")


def setup(args):
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def _load_params(cfg, args, model_cls):
    """``model_cls`` of ``cfg`` on MODEL.DEVICE with the checkpoint's
    weights, in eval mode."""
    device = torch.device(cfg.MODEL.DEVICE)
    ckptr = Checkpointer(cfg.OUTPUT_DIR)
    name = args.ckpt or ckptr.get_last_checkpoint() or "model_final"
    state = ckptr.load(name, map_location=device)
    role = "teacher" if cfg.SEMISUPNET.EVAL_TEACHER and "teacher" in state else "model"
    model = load_weights(model_cls.from_cfg(cfg, device="meta"), state.get(role, state), device)
    logger.info("Loaded the %s of %s (iteration %s)", role, ckptr.path(name), state.get("iter"))
    return model.eval()


def _test_dataset_dicts(cfg, name):
    register_all_voc()
    proposal_files = None
    if cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TEST:
        proposal_files = [cfg.DATASETS.PROPOSAL_FILES_TEST[list(cfg.DATASETS.TEST).index(name)]]
    return get_detection_dataset_dicts([name], filter_empty=False, proposal_files=proposal_files)


def _evaluator(name):
    meta = MetadataCatalog.get(name)
    return PascalVOCDetectionEvaluator(
        name, annotations_from_dataset_dicts(DatasetCatalog.get(name), meta.get("dirname")),
        meta.thing_classes, year=int(meta.get("year", 2007)))


@contextlib.contextmanager
def _inference(model):
    """Inference mode, with bfloat16 autocast when the model computes in it."""
    device = next(model.parameters()).device
    with torch.inference_mode(), torch.autocast(
            device.type, dtype=torch.bfloat16, enabled=model.compute_dtype == torch.bfloat16):
        yield


def _to_device(batch, device, keys):
    with record_function("h2d"):
        return {k: torch.as_tensor(batch[k], device=device) for k in keys}


def _numpy(*tensors):
    return tuple(t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                 for t in tensors)


def _run(cfg, name, dicts, per_image):
    """``per_image(d, image) -> (boxes, scores, classes, valid)`` in image
    coordinates for each dict, into the VOC evaluator of ``name``."""
    evaluator = _evaluator(name)
    evaluator.reset()
    for i, d in enumerate(dicts):
        evaluator.process_single(d["image_id"], *per_image(d, read_image_bgr(d["file_name"])))
        if (i + 1) % 200 == 0:
            logger.info("TTA inference %d/%d images", i + 1, len(dicts))
    results = evaluator.evaluate()
    logger.info("TTA results for %s: %s", name, dict(results))
    return results


def eval_wsl_tta(cfg, args):
    """Stage 1: AVG (the scores and class boxes of each proposal averaged
    over the views, then one NMS) or UNION (each view's detections, one NMS
    on the host)."""
    if cfg.MODEL.META_ARCHITECTURE != "MultiInputRCNN":
        # the JAX tool builds MultiInputRCNN for any stage-1 config, which a
        # single-view checkpoint does not fit
        raise NotImplementedError(
            f"MODEL.META_ARCHITECTURE {cfg.MODEL.META_ARCHITECTURE!r}: test-time augmentation "
            "of stage 1 runs the multi-input model (MultiInputRCNN) only")
    model = _load_params(cfg, args, MultiInputRCNN)
    device = next(model.parameters()).device
    keys = ("image", "valid_hw", "boxes", "objectness", "prop_valid", "image_hw")

    def raw_predict(batch):
        with _inference(model):
            return _numpy(*model.predict_scores(_to_device(batch, device, keys)))

    def det_predict(batch):
        with _inference(model):
            det = model.predict(_to_device(batch, device, keys))[0]
            return _numpy(det.boxes, det.scores, det.classes, det.valid)

    kw = dict(min_sizes=cfg.TEST.AUG.MIN_SIZES, max_size=cfg.TEST.AUG.MAX_SIZE,
              flip=cfg.TEST.AUG.FLIP, capacity=cfg.TPU.PROPOSAL_CAPACITY,
              size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY)

    def per_image(d, image):
        raw_boxes = np.asarray(d.get("proposal_boxes", np.zeros((1, 4))), np.float32)
        raw_logits = np.asarray(d.get("proposal_objectness_logits", np.zeros(1)), np.float32)
        if args.strategy == "union":
            boxes, scores, classes = tta_union_detections(
                det_predict, image, raw_boxes, raw_logits,
                nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                topk=cfg.TEST.DETECTIONS_PER_IMAGE, **kw)
            return boxes, scores, classes, np.ones(len(scores), bool)
        scores, boxes, valid = tta_avg_scores(raw_predict, image, raw_boxes, raw_logits, **kw)
        with _inference(model), record_function("nms_topk"):
            det = fast_rcnn_inference_single(
                torch.as_tensor(boxes, dtype=torch.float32, device=device),
                torch.as_tensor(scores, dtype=torch.float32, device=device),
                torch.as_tensor(valid, device=device),
                torch.tensor([d["height"], d["width"]], dtype=torch.float32, device=device),
                score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, topk=cfg.TEST.DETECTIONS_PER_IMAGE)
            return _numpy(det.boxes, det.scores, det.classes, det.valid)

    return OrderedDict((name, _run(cfg, name, _test_dataset_dicts(cfg, name), per_image))
                       for name in cfg.DATASETS.TEST)


def eval_frcnn_tta(cfg, args):
    """Stages 2-3: the union of each view's detections, one NMS on the
    host."""
    model = _load_params(cfg, args, GeneralizedRCNN)
    device = next(model.parameters()).device

    def infer_fn(batch):
        with _inference(model):
            det = model.predict(_to_device(batch, device, ("image", "image_hw")))[0]
            return _numpy(det.boxes, det.scores, det.classes, det.valid)

    def per_image(d, image):
        boxes, scores, classes = tta_union_detections(
            infer_fn, image, np.zeros((1, 4), np.float32), np.zeros(1, np.float32),
            min_sizes=cfg.TEST.AUG.MIN_SIZES, max_size=cfg.TEST.AUG.MAX_SIZE,
            flip=cfg.TEST.AUG.FLIP, capacity=1, size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, topk=cfg.TEST.DETECTIONS_PER_IMAGE)
        return boxes, scores, classes, np.ones(len(scores), bool)

    return OrderedDict((name, _run(cfg, name, _test_dataset_dicts(cfg, name), per_image))
                       for name in cfg.DATASETS.TEST)


def main(args):
    """The TTA evaluation of each of DATASETS.TEST; returns the results by
    dataset. ``--strategy auto`` is avg for the stage-1 models, union for
    the Faster R-CNN."""
    cfg = setup(args)
    is_wsl = cfg.MODEL.META_ARCHITECTURE in WSL_ARCHS
    if args.strategy == "auto":
        args.strategy = "avg" if is_wsl else "union"
    results = eval_wsl_tta(cfg, args) if is_wsl else eval_frcnn_tta(cfg, args)
    if cfg.TEST.EXPECTED_RESULTS:
        verify_results(cfg, results)
    return results


def argument_parser():
    parser = default_argument_parser()
    parser.add_argument("--strategy", default="auto", choices=("auto", "avg", "union"))
    parser.add_argument("--ckpt", default="")
    return parser


if __name__ == "__main__":
    main(argument_parser().parse_args())
