"""Stage-1 inference runner.

Counterpart of ``run_stage1_inference`` in ``sos_wsod_tpu/engine/defaults.py``
(detectron2's inference_on_dataset + detector_postprocess): single-image
OICR+ inference over a test stream, detections rescaled to the original image
size and handed to the evaluator, whose JSON dump is the stage-1 -> stage-2
contract.
"""
from __future__ import annotations

import logging
import time
from collections import OrderedDict
from typing import Iterable

import torch
from torch.profiler import record_function

from ..models.postprocess import rescale_detections

logger = logging.getLogger(__name__)


def inference_on_samples(model, data_iter: Iterable, evaluator, device) -> int:
    """Drive ``model.predict`` over samples with the keys of the JAX package's
    ``DatasetMapperTest`` (image, valid_hw, boxes, objectness, prop_valid,
    image_hw, orig_hw, image_id) and hand each image's rescaled detections to
    ``evaluator.process_single``. Returns the number of images.

    Runs under ``torch.inference_mode()``, with bfloat16 autocast when the
    model's ``compute_dtype`` is bfloat16. The profiler ranges ``h2d`` and
    ``rescale_eval`` (and those of ``predict``) cover each step."""
    device = torch.device(device)
    model.eval()
    n = 0
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.autocast(
            device.type, dtype=torch.bfloat16,
            enabled=model.compute_dtype == torch.bfloat16):
        for sample in data_iter:
            with record_function("h2d"):
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in sample.items() if k != "image_id"}
            det, _, _ = model.predict(batch)
            with record_function("rescale_eval"):
                det = rescale_detections(det, batch["image_hw"], batch["orig_hw"])
                evaluator.process_single(
                    sample["image_id"], det.boxes.cpu().numpy(), det.scores.cpu().numpy(),
                    det.classes.cpu().numpy(), det.valid.cpu().numpy())
            n += 1
            if n % 500 == 0:
                logger.info("Inference %d images (%.3f s/img)", n,
                            (time.perf_counter() - t0) / n)
    return n


def run_stage1_inference(model, data_iter: Iterable, evaluator, device) -> OrderedDict:
    """``inference_on_samples`` into a freshly reset ``evaluator``, then its
    ``evaluate()`` (which writes the detection-result JSON when asked to);
    returns the evaluator's results."""
    evaluator.reset()
    inference_on_samples(model, data_iter, evaluator, device)
    results = evaluator.evaluate()
    logger.info("Evaluation results: %s", dict(results))
    return results
