"""One try of a training cell in data parallel over several cards: the
reference's own stage-1 job (IMS_PER_BATCH 4 over 4 GPUs, one image a
rank) through the system's launcher (``engine/launch.py:spawn``), its
process group (NCCL on cards, gloo on the CPU) and DistributedDataParallel.

    python3 -m wsod_bench.dp_try --workload oicr_plus.train --ranks 4 --seed 1 --steps 60

Each rank builds the model from the seed's weights, its share of the
seed's images through the system's mapper and stream, and the trainer
with the global batch of one image a rank; after the mix's warm steps it
times ``--steps`` steps (a CUDA event at each step's end, a synchronize
at each end of the window). Prints one JSON line: the images of all
ranks a second, each rank's wall time, step times and peak memory, and
the largest relative difference of a parameter's norm from rank 0's
after the steps (DistributedDataParallel keeps the replicas equal: 0).
It is not a cell: it compares nothing with the reference, and the
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
import time

import numpy as np

from . import run, spec, synth, weights as weights_mod

OUT = spec.ROOT / "build" / "wsod_bench" / "dp_try"


def _rank(workload: str, seed: int, steps: int, device: str, overrides: list) -> None:
    import torch
    import torch.distributed as dist
    from sos_wsod_torch.data.build import batched_stream
    from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
    from sos_wsod_torch.engine.trainer import Stage1Trainer
    from sos_wsod_torch.utils.events import EventStorage

    world, rank = dist.get_world_size(), dist.get_rank()
    cell = spec.load(spec.ROOT / "BENCHMARK.json", workload)
    ctx = run.Context(cell, seed, 0.0, False, device, time.perf_counter(), list(overrides))
    cfg = ctx.port_cfg()
    cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", world * cfg.SOLVER.IMS_PER_BATCH])
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    fam = cell.model()
    st = fam.settings(cfg.to_dict())
    dicts = synth.dataset_dicts(cell.traffic, st["num_classes"], seed)
    model = fam.build(cfg, weights_mod.make(fam.param_shapes(st), cell.config["init"], seed,
                                            dev), dev)
    stream = batched_stream(
        dicts, DatasetMapperMultiInput.from_cfg(cfg), cfg.SOLVER.IMS_PER_BATCH // world,
        seed=max(cfg.SEED, 0), size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING, rank=rank, world=world)
    trainer = Stage1Trainer(cfg, model, stream)
    t_setup = time.perf_counter() - ctx.t0

    def event():
        if dev.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with EventStorage(0) as storage:
        trainer.storage = storage

        def step():
            trainer.iter = storage.iter
            trainer.run_step()
            storage.step()

        for _ in range(int(cell.traffic["warm_steps"]) + 1):
            step()
        sync()
        t = time.perf_counter()
        ends = [event()]
        for _ in range(steps):
            step()
            ends.append(event())
        sync()
        wall = time.perf_counter() - t
    stream.close()
    step_ms = [a.elapsed_time(b) for a, b in zip(ends[:-1], ends[1:])] if dev.type == "cuda" \
        else []
    with torch.no_grad():
        norms = torch.stack([p.detach().float().norm() for p in model.parameters()])
        every = [torch.empty_like(norms) for _ in range(world)]
        dist.all_gather(every, norms)
        spread = max(float(((n - every[0]).abs() / every[0].clamp(min=1e-30)).max())
                     for n in every)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "world": world, "setup_s": t_setup, "wall_s": wall, "steps": steps,
        "images": steps * cfg.SOLVER.IMS_PER_BATCH // world,
        "step_ms_median": float(np.median(step_ms)) if step_ms else None,
        "step_ms_p90": float(np.percentile(step_ms, 90)) if step_ms else None,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
        if dev.type == "cuda" else 0,
        "replica_norm_spread": spread,
        "backend": dist.get_backend()}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--set", nargs="*", default=[],
                    help="KEY VALUE pairs on the configuration (small sizes on the CPU)")
    args = ap.parse_args(argv)
    run.pin_caches(spec.ROOT)
    from sos_wsod_torch.engine.launch import spawn

    for old in OUT.glob("rank*.json"):
        old.unlink()
    spawn(_rank, args.ranks, args=(args.workload, args.seed, args.steps, args.device, args.set),
          device=args.device, timeout=datetime.timedelta(minutes=3))
    ranks = [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(args.ranks)]
    wall = max(r["wall_s"] for r in ranks)
    print(json.dumps({"workload": args.workload, "ranks": args.ranks, "seed": args.seed,
                      "train_img_per_s": sum(r["images"] for r in ranks) / wall,
                      "per_rank": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
