"""The clean/noisy split of stage 3: each training image scored by the
stage-2 student's loss, the lowest-loss k kept as labeled.

Counterpart of ``sos_wsod_tpu/tools/splits.py`` (the reference's
unbias/generate_base_split.py and split_single.py):
  - ``bisect_percent_for_k``, ``bisect_percent_direct``,
    ``generate_base_split`` and ``split_by_losses``: the host half, the same
    arithmetic (the bisection to 7 decimals, the stable ascending sort);
  - ``score_dataset_losses``: per image, the sum of loss_cls, loss_box_reg,
    loss_rpn_cls and loss_rpn_loc of ``GeneralizedRCNN.losses`` under
    ``torch.no_grad`` (bf16 autocast when TPU.COMPUTE_DTYPE is bfloat16),
    the sampling draws of each image from a torch.Generator seeded with
    ``comm.derive_seed(seed, position)`` by its position in the dataset
    (the JAX package's fold_in(key, i)), so an image's score does not
    depend on which process scores it;
  - ``main``: the student ("model") of a checkpoint of the port scores the
    weak view of each image of DATASETS.TRAIN, mapped by
    DatasetMapperTwoCropSeparate at INPUT.MIN_SIZE_TEST without a flip, and
    the dataseed JSON {percent: {"1": [positions]}} is written; with
    ``--base-only`` the all-but-one split, with no scoring. In a process
    group (``--num-gpus``, or torchrun) rank r scores the images r, r + W,
    ... of the W ranks, the (position, id, loss) triples are gathered to
    every rank (``comm.process_gather``) and put back in dataset order, a
    repeated id keeping its first score, as the JAX tool dedupes; every
    rank computes the split and rank 0 writes it, byte-identical to one
    process's. (The JAX tool sorts the gathered pairs in rank order, so its
    positions at more than one process are those of that order.)

    python -m sos_wsod_torch.tools.splits [--num-gpus N] \\
        --config configs/stage23/voc_split.yaml \\
        --ckpt output/voc_baseline/model_final --save-path dataseed/VOC07_oicr_plus_split.txt \\
        --k 2000 [--base-only] [KEY VALUE ...]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.defaults import add_launch_arguments

LOSS_KEYS = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc")


def bisect_percent_for_k(length: int, k: int) -> float:
    """Find percent (middle*100, middle rounded to 7 decimals) such that
    int(length * middle) == k (split_single.py:94-109)."""
    low = k / length
    high = (k + 1) / length
    while True:
        middle = round((low + high) / 2, 7)
        val = int(length * middle)
        if val == k:
            return middle * 100
        elif val > k:
            high = middle
        else:
            low = middle


def bisect_percent_direct(length: int, target: int) -> float:
    """generate_base_split variant: percent in [0, 100] with
    int(percent/100*length) == target (generate_base_split.py:35-45)."""
    low, high = 0.0, 100.0
    while True:
        middle = round((low + high) / 2, 7)
        val = int(middle / 100 * length)
        if val == target:
            return middle
        elif val < target:
            low = middle
        else:
            high = middle


def generate_base_split(dataset_len: int) -> Dict:
    """Dataseed marking all-but-one images as labeled."""
    target = dataset_len - 1
    percent = bisect_percent_direct(dataset_len, target)
    return {str(percent): {"1": list(range(target))}}


def split_by_losses(image_ids: Sequence[int], losses: Sequence[float], k: int
                    ) -> Tuple[Dict, float]:
    """Sort ascending by loss, map the k lowest-loss image ids back to dataset
    positions (VOC order == scoring order), bisect the percent."""
    losses = np.asarray(losses, np.float32)
    order = np.argsort(losses, kind="stable")
    imgid2pos = {int(image_ids[i]): i for i in range(len(image_ids))}
    clean_positions = [imgid2pos[int(image_ids[i])] for i in order]
    length = len(image_ids)
    percent = bisect_percent_for_k(length, k)
    return {str(percent): {"1": clean_positions[:k]}}, percent


def score_dataset_losses(model, samples: Iterable[Dict[str, np.ndarray]],
                         loss_keys: Sequence[str] = LOSS_KEYS, seed: int = 0,
                         positions: Optional[Iterable[int]] = None
                         ) -> Tuple[List[int], List[float]]:
    """Per-image sum of ``loss_keys`` of ``model.losses`` (a
    ``GeneralizedRCNN``) on the device of its parameters, with no gradient.
    ``samples`` yields mapped dicts with ``image_id``; image i draws from a
    generator seeded with ``comm.derive_seed(seed, positions[i])``
    (``positions`` 0, 1, ... by default). The losses are read back once,
    after the last image."""
    from ..engine.ubteacher import stack_samples
    from ..parallel.comm import derive_seed

    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    bf16 = model.compute_dtype == torch.bfloat16
    ids, losses = [], []
    positions = itertools.count() if positions is None else iter(positions)
    with torch.no_grad(), torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
        for sample in samples:
            generator.manual_seed(derive_seed(seed, next(positions)))
            out = model.losses(stack_samples([sample], device), generator)
            ids.append(int(sample["image_id"]))
            losses.append(sum(out[k].float() for k in loss_keys))
    return ids, (torch.stack(losses).tolist() if losses else [])


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("Perform dataset split.")
    parser.add_argument("--config", default="configs/stage23/voc_split.yaml")
    parser.add_argument("--ckpt", default="output/voc_baseline/model_final")
    parser.add_argument("--save-path", default="dataseed/VOC07_oicr_plus_split.txt")
    parser.add_argument("--k", default=2000, type=int)
    parser.add_argument("--base-only", action="store_true",
                        help="generate_base_split mode (no model scoring)")
    add_launch_arguments(parser)
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="config overrides, KEY VALUE pairs at the end")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Optional[float]]:
    """Write the dataseed; returns it and its percent (None with
    ``--base-only``)."""
    from ..config import get_cfg
    from ..data.build import get_detection_dataset_dicts
    from ..data.datasets.voc import register_all_voc
    from ..parallel import comm

    args = parse_args(argv)
    rank, world = comm.get_rank(), comm.get_world_size()
    cfg = get_cfg()
    cfg.merge_from_file(args.config)
    cfg.merge_from_list(args.opts or [])
    register_all_voc()
    dataset_dicts = get_detection_dataset_dicts(cfg.DATASETS.TRAIN, filter_empty=False)

    percent = None
    if args.base_only:
        split = generate_base_split(len(dataset_dicts))
    else:
        from ..data.mapper_twocrop import DatasetMapperTwoCropSeparate
        from ..engine.checkpoint import Checkpointer
        from ..engine.weights import load_weights
        from ..models.meta.rcnn import GeneralizedRCNN

        device = comm.local_device(cfg.MODEL.DEVICE)
        state = Checkpointer(os.path.dirname(args.ckpt) or ".").load(
            os.path.basename(args.ckpt), map_location=device)
        model = load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"),
                             state.get("model", state), device)
        # the weak view at a fixed scale, no flip: a deterministic score
        mapper = DatasetMapperTwoCropSeparate(
            min_size_train=[cfg.INPUT.MIN_SIZE_TEST], max_size_train=cfg.INPUT.MAX_SIZE_TEST,
            random_flip=False, gt_capacity=cfg.TPU.PGT_CAPACITY,
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY)
        mine = range(rank, len(dataset_dicts), world)
        ids, losses = score_dataset_losses(model, (mapper(dataset_dicts[i])[1] for i in mine),
                                           positions=mine)
        if world > 1:
            triples = sorted(comm.process_gather(list(zip(mine, ids, losses))))
            seen: Dict[int, float] = {}
            for _, i, loss in triples:
                seen.setdefault(int(i), float(loss))
            ids, losses = list(seen), list(seen.values())
        split, percent = split_by_losses(ids, losses, args.k)
        if comm.is_main_process():
            print(f"The finded percent is: {percent}", flush=True)

    if comm.is_main_process():
        os.makedirs(os.path.dirname(args.save_path) or ".", exist_ok=True)
        with open(args.save_path, "w") as f:
            json.dump(split, f)
    comm.synchronize()
    return split, percent


if __name__ == "__main__":
    from ..engine.defaults import config_device
    from ..engine.launch import launch

    cli_args = parse_args()
    launch(main, cli_args.num_gpus, cli_args.num_machines, cli_args.machine_rank,
           cli_args.dist_url, args=(sys.argv[1:],),
           device=config_device(cli_args.config, cli_args.opts))
