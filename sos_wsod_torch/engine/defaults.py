"""Command-line setup and the stage-1 inference runner.

Counterpart of ``sos_wsod_tpu/engine/defaults.py`` (detectron2's
default_argument_parser, default_setup, inference_on_dataset +
detector_postprocess): the CLI's parser, logging, the run directory's
``config.yaml`` and seeding, the WSL trainer's ``auto_scale_workers``, the
device a CLI launches its processes for (``config_device``), and
single-image OICR+ inference over a test stream, detections rescaled to the
original image size and handed to the evaluator, whose JSON dump is the
stage-1 -> stage-2 contract.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..models.postprocess import rescale_detections
from ..parallel import comm

logger = logging.getLogger(__name__)


def default_argument_parser(epilog: Optional[str] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(epilog=epilog)
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    add_launch_arguments(parser)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options 'KEY VALUE' pairs at the end")
    return parser


def add_launch_arguments(parser: argparse.ArgumentParser) -> None:
    """The launcher's flags (``engine/launch.py``), as detectron2 names them."""
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="processes on this machine, one a GPU")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0,
                        help="the rank of this machine, 0 to --num-machines - 1")
    parser.add_argument("--dist-url", default="auto",
                        help="the process group's address: tcp://host:port of machine 0 "
                             "with more than one machine; 'auto' picks a free local port")


def config_device(config_file: str, opts) -> str:
    """MODEL.DEVICE of ``config_file`` with the KEY VALUE pairs ``opts``:
    the device a CLI launches its processes for."""
    from ..config import get_cfg

    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    cfg.merge_from_list(opts or [])
    return cfg.MODEL.DEVICE


def setup_logging(output_dir: str = "") -> None:
    """INFO logging to stdout and, with ``output_dir``, to its log.txt. In a
    process group every line carries the rank, and only rank 0 writes the
    file."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if output_dir and comm.is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, "log.txt")))
    rank = f"rank {comm.get_rank()} " if comm.get_world_size() > 1 else ""
    logging.basicConfig(level=logging.INFO, handlers=handlers, force=True,
                        format=f"[%(asctime)s] {rank}%(name)s %(levelname)s: %(message)s")


def default_setup(cfg, args) -> None:
    """Logging, ``OUTPUT_DIR``/config.yaml (written by rank 0) and numpy's
    seed (SEED >= 0). Raises when the flags ask for more than one process
    but this one is in no process group (``main`` called without
    ``engine.launch.launch``)."""
    wanted = args.num_gpus * args.num_machines
    if wanted > 1 and comm.get_world_size() == 1:
        raise RuntimeError(f"--num-gpus {args.num_gpus} --num-machines {args.num_machines} but "
                           "this process is in no process group: start the CLI through "
                           "engine.launch.launch (python -m ...), which spawns the processes")
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Command line args: %s", args)
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        if comm.is_main_process():
            with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
                f.write(cfg.dump())
    if cfg.SEED >= 0:
        np.random.seed(cfg.SEED)


def auto_scale_workers(cfg, num_workers: int):
    """With SOLVER.REFERENCE_WORLD_SIZE set and larger than ``num_workers``,
    a copy of ``cfg`` with BASE_LR divided and WSL.ITER_SIZE ceil-multiplied
    by the ratio, so that gradient accumulation keeps the reference's batch
    per update; else ``cfg`` itself. A frozen config stays frozen."""
    old_world_size = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old_world_size in (0, num_workers) or old_world_size < num_workers:
        return cfg
    frozen = cfg.is_frozen()
    cfg = cfg.clone()
    scale = num_workers / old_world_size
    lr = cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR / scale
    iter_size = cfg.WSL.ITER_SIZE = math.ceil(cfg.WSL.ITER_SIZE / scale)
    logger.info("Auto-scaling the config to iter_size=%s, learning_rate=%s", iter_size, lr)
    if frozen:
        cfg.freeze()
    return cfg


def inference_on_samples(model, data_iter: Iterable, evaluator, device) -> int:
    """Drive ``model.predict`` over samples with the keys of the JAX package's
    ``DatasetMapperTest`` (image, valid_hw, boxes, objectness, prop_valid,
    image_hw, orig_hw, image_id) and hand each image's rescaled detections to
    ``evaluator.process_single``. Returns the number of images. The
    detections are the first output of ``predict``: a WSJDS model also
    returns its class masks, which no evaluator reads (the JAX package's
    inference unpacks three outputs and raises for it).

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
            det = model.predict(batch)[0]   # a WSJDS model's masks go unread
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
