"""Entry points: the flagship forward and a multi-process training dryrun.

Counterpart of the repository's ``__graft_entry__.py``:
  - ``entry(device=None)`` returns ``(fn, args)``: the inference forward of
    the flagship stage-1 model (MultiInputRCNN, OICR+ on VGG16, full DAN
    widths, seed_cap 128, 100 detections) on one 256 x 320 image with 512
    proposals, its weights random from a seed. ``fn(*args)`` returns
    (all_scores, all_boxes, detection boxes, detection scores), as the JAX
    ``fn`` does;
  - ``dryrun_multichip(n, device=None)`` runs n ranks through
    ``engine/launch.py``: one data-parallel training step at tiny widths
    (seed_cap 32, DAN 64/64, P = 32, views of 48 x 64 and 64 x 80), and for
    even n >= 4 the same step from the same state and batch on a dp x tp
    split (tp = 4 when 4 divides n, else 2; ``parallel/tensor.py``), whose
    loss must lie within 5e-2 x max(1, |loss|) of the data-parallel one.
    The DAN's dropout is off in both: their masks come from generators
    seeded by the data-parallel rank, which the two splits number
    differently, and at 0.5 the masks alone moved the loss by 4.7% on the
    CPU;
    NCCL with a card a rank where there are n cards, gloo ranks sharing the
    cards where there are fewer; the CPU over gloo only for ``device="cpu"``.
Both run on the card unless the caller asks for the CPU.

    python -m sos_wsod_torch.entry [--device cpu] [--n 4]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

SEED = 0
DRYRUN_LOSS_RTOL = 5e-2   # the JAX dryrun's bound on the dp x tp step's loss


def _device(device) -> torch.device:
    """``device``, the card when None; the card must be there."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def _tiny_image_batch(rng: np.random.RandomState, p: int, h1: int, w1: int, h2: int,
                      w2: int) -> Dict[str, torch.Tensor]:
    """One 4-view training sample (two scales x {identity, hflip}) of a
    random image with ``p`` random proposals, on canvases padded to
    multiples of 64: the JAX ``_tiny_image_batch`` draw for draw."""
    def rand_boxes(n, h, w):
        x1 = rng.uniform(0, w - 8, n)
        y1 = rng.uniform(0, h - 8, n)
        x2 = np.minimum(x1 + rng.uniform(4, w / 2, n), w)
        y2 = np.minimum(y1 + rng.uniform(4, h / 2, n), h)
        return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)

    boxes1 = rand_boxes(p, h1, w1)
    scale = np.array([w2 / w1, h2 / h1, w2 / w1, h2 / h1], np.float32)
    boxes2 = boxes1 * scale
    b1f = boxes1.copy()
    b1f[:, [0, 2]] = w1 - boxes1[:, [2, 0]]
    b2f = boxes2.copy()
    b2f[:, [0, 2]] = w2 - boxes2[:, [2, 0]]
    oh = np.zeros(20, np.float32)
    oh[[1, 7]] = 1

    def pad(img, ch, cw):
        out = np.zeros((ch, cw, 3), np.float32)
        out[: img.shape[0], : img.shape[1]] = img
        return out

    def bucket(v, d=64):
        return -(-v // d) * d

    c1, c2 = (bucket(h1), bucket(w1)), (bucket(h2), bucket(w2))
    img1 = rng.uniform(0, 255, (h1, w1, 3))
    img2 = rng.uniform(0, 255, (h2, w2, 3))
    batch = {
        "images_s1": np.stack([pad(img1, *c1), pad(img1[:, ::-1], *c1)]),
        "images_s2": np.stack([pad(img2, *c2), pad(img2[:, ::-1], *c2)]),
        "valid_hw_s1": np.array([[h1, w1], [h1, w1]], np.int32),
        "valid_hw_s2": np.array([[h2, w2], [h2, w2]], np.int32),
        "boxes": np.stack([boxes1, b1f, boxes2, b2f]),
        "objectness": rng.uniform(0, 1, p).astype(np.float32),
        "prop_valid": np.ones(p, bool),
        "gt_classes_oh": oh,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _seeded_model(device, **kw):
    """MultiInputRCNN(**kw) with the random OICR+ weights of
    ``engine/synthetic.py:random_d2_wsl_blobs`` from ``SEED``."""
    from .engine.synthetic import random_d2_wsl_blobs
    from .engine.weights import load_weights, state_dict_from_d2_wsl
    from .models.meta.rcnn_wsl import MultiInputRCNN

    model = MultiInputRCNN(num_classes=20, device="meta", **kw)
    head = model.roi_heads
    blobs = random_d2_wsl_blobs(SEED, 20, head.refine_k, kw.get("dan_dims", (4096, 4096)))
    return load_weights(model, state_dict_from_d2_wsl(blobs, keep=model.state_dict()), device)


def entry(device=None):
    """(fn, (model, batch)): single-image inference of the flagship OICR+
    model; ``fn(model, batch)`` -> (all_scores (P, K+1), all_boxes (P, 4K),
    detection boxes, detection scores)."""
    device = _device(device)
    rng = np.random.RandomState(0)
    p, h, w = 512, 256, 320
    x1 = rng.uniform(0, w - 8, p)
    y1 = rng.uniform(0, h - 8, p)
    x2 = np.minimum(x1 + rng.uniform(4, w / 2, p), w)
    y2 = np.minimum(y1 + rng.uniform(4, h / 2, p), h)
    boxes = np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)
    batch = {
        "image": torch.from_numpy(rng.uniform(0, 255, (h, w, 3)).astype(np.float32)),
        "valid_hw": torch.tensor([h, w], dtype=torch.int32),
        "boxes": torch.from_numpy(boxes),
        "objectness": torch.from_numpy(rng.uniform(0, 1, p).astype(np.float32)),
        "prop_valid": torch.ones(p, dtype=torch.bool),
        "image_hw": torch.tensor([h, w], dtype=torch.float32),
    }
    batch = {k: v.to(device) for k, v in batch.items()}
    model = _seeded_model(device, seed_cap=128, detections_per_image=100)

    def fn(model, batch):
        with torch.inference_mode():
            det, all_scores, all_boxes = model.predict(batch)
        return all_scores, all_boxes, det.boxes, det.scores

    return fn, (model, batch)


def _dryrun_rank(device: str, out_dir: Optional[str]) -> None:
    """What each rank of ``dryrun_multichip`` runs."""
    from .config import get_cfg
    from .engine.trainer import Stage1Trainer
    from .parallel import comm, tensor
    from .tools.check_ddp import card_flags, kernel_launches

    card_flags()
    device = comm.local_device(device)
    rank, world = comm.get_rank(), comm.get_world_size()
    if device.type == "cpu" and world > 1:
        torch.set_num_threads(1)   # the ranks share the host's cores; the widths are tiny
    rng = np.random.RandomState(0)
    samples = [_tiny_image_batch(rng, p=32, h1=48, w1=64, h2=64, w2=80) for _ in range(world)]
    cfg = get_cfg()
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", world, "SOLVER.BASE_LR", 1e-3,
                         "SOLVER.STEPS", (100,), "SOLVER.MOMENTUM", 0.9,
                         "SOLVER.WEIGHT_DECAY", 0.0, "SOLVER.WEIGHT_DECAY_BIAS", 0.0,
                         "SEED", SEED])

    def step(tp: int) -> Dict[str, float]:
        tensor.init(tp)
        dp_rank, dp = tensor.data_rank(), tensor.data_world_size()
        share = world // dp
        model = _seeded_model(device, seed_cap=32, dan_dims=(64, 64), dan_dropout=0.0)
        trainer = Stage1Trainer(cfg, model,
                                iter([samples[dp_rank * share:(dp_rank + 1) * share]]))
        trainer.train(0, 1)
        hist = trainer.storage.histories()
        return {k: h.latest for k, h in hist.items() if k != "data_time"}

    before = kernel_launches()
    report = {"dp": step(1)}
    total = report["dp"]["total_loss"]
    if not np.isfinite(total):
        raise FloatingPointError(f"non-finite loss {total}")
    if rank == 0:
        print(f"dryrun_multichip({world}) OK: total_loss={total:.4f}, "
              f"losses={ {k: round(v, 4) for k, v in report['dp'].items()} }", flush=True)
    if world % 2 == 0 and world >= 4:
        tp = 4 if world % 4 == 0 else 2
        report["tp"] = tp
        report["dp_tp"] = step(tp)
        total_tp = report["dp_tp"]["total_loss"]
        if not np.isfinite(total_tp):
            raise FloatingPointError(f"non-finite TP loss {total_tp}")
        if abs(total_tp - total) >= DRYRUN_LOSS_RTOL * max(1.0, abs(total)):
            raise AssertionError(f"dp vs dp{world // tp}xtp{tp} loss mismatch: "
                                 f"{total} vs {total_tp}")
        if rank == 0:
            print(f"dryrun_multichip dp{world // tp}xtp{tp} OK: total_loss={total_tp:.4f}",
                  flush=True)
        tensor.init(1)
    after = kernel_launches()
    report["launches"] = {k: after[k] - before[k] for k in after}
    if out_dir:
        torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))


def dryrun_multichip(n: int, device=None, out_dir: Optional[str] = None) -> None:
    """One data-parallel training step over ``n`` ranks, then (n even, >= 4)
    the same step split dp x tp; prints an OK line for each and raises on
    failure. ``out_dir``: each rank writes ``rank<r>.pt`` (its losses and
    the kernels' launches)."""
    from .engine.launch import launch

    dev = _device(device)
    if dev.type == "cuda":
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    else:
        backend = "gloo"
    launch(_dryrun_rank, n, args=(dev.type, out_dir), backend=backend, device=dev.type)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, else the card")
    parser.add_argument("--n", type=int, default=4, help="ranks of the dryrun")
    args = parser.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
