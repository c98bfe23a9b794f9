"""Training traffic: the system's trainer step back to back, a closed loop.

Set-up makes the mix's images and the weights from the seed, builds the
model, the system's mapper and batched stream (in the configuration's
loader threads) and its trainer, and drives the trainer through its first
steps (the compared steps, which also warm up). The window then calls the
same trainer's ``run_step`` until ``--seconds`` have passed, with a CUDA
event at each step's end and a synchronize at each end of the window only.
A traced run then profiles ``trace_steps`` more steps. Once the program's
state is freed, the plain reference redoes the compared steps from the
same weights and images.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import compare, synth, weights as weights_mod
from ..trace import Trace
from .common import Observed, device_line, sync, usage, usage_line


class Feed:
    """The system's batch stream, with each batch's sizes kept."""

    def __init__(self, stream):
        self.stream = stream
        self.sizes: List[List[Dict[str, np.ndarray]]] = []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.stream)
        self.sizes.append([{k: s[k] for k in ("valid_hw_s1", "valid_hw_s2", "prop_valid")}
                           for s in batch])
        return batch


def _named_trained(trainer):
    return [(g["name"], g["params"][0], g["weight_decay"]) for g in trainer.optimizer.param_groups]


def run(ctx) -> Dict:
    from sos_wsod_torch.data.build import batched_stream
    from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
    from sos_wsod_torch.engine.trainer import Stage1Trainer
    from sos_wsod_torch.utils.events import EventStorage

    cell, mix, dev = ctx.cell, ctx.cell.traffic, torch.device(ctx.device)
    model_fam = cell.model()
    cfg = ctx.port_cfg()
    tree = cfg.to_dict()
    st = model_fam.settings(tree)
    shapes = model_fam.param_shapes(st)
    marks = [("imports", time.perf_counter())]
    dicts = synth.dataset_dicts(mix, st["num_classes"], ctx.seed)
    marks.append(("inputs", time.perf_counter()))
    model = model_fam.build(cfg, weights_mod.make(shapes, cell.config["init"], ctx.seed, dev), dev)
    marks.append(("model", time.perf_counter()))
    feed = Feed(batched_stream(
        dicts, DatasetMapperMultiInput.from_cfg(cfg), cfg.SOLVER.IMS_PER_BATCH,
        seed=max(cfg.SEED, 0), size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING))
    trainer = Stage1Trainer(cfg, model, feed)
    n_check = int(mix["check_steps"])
    with EventStorage(0) as storage:
        trainer.storage = storage

        def step():
            trainer.iter = storage.iter
            trainer.run_step()
            storage.step()
            return storage.latest()

        # the compared steps: losses, the first gradient as the optimizer
        # holds it (momentum buffer minus weight decay), the change after
        p0 = {n: p.detach().to("cpu", copy=True) for n, p, _ in _named_trained(trainer)}
        prog_losses, prog_grads, mining = [], {}, []
        for i in range(n_check):
            with model_fam.recording_mining(mining):
                latest = step()
            prog_losses.append({k: latest[k][0] for k in ("total_loss", "loss_cls")})
            if i == 0:
                for n, p, wd in _named_trained(trainer):
                    buf = trainer.optimizer.state.get(p, {}).get("momentum_buffer")
                    prog_grads[n] = 0.0 if buf is None else \
                        float((buf - wd * p0[n].to(dev)).norm())
        with torch.no_grad():
            prog_change = {n: float((p.detach() - p0[n].to(dev)).norm())
                           for n, p, _ in _named_trained(trainer)}
        del p0
        marks.append(("compared steps", time.perf_counter()))
        for _ in range(int(mix["warm_steps"])):
            step()
        marks.append(("warm steps", time.perf_counter()))

        sync(dev)
        t_start = time.perf_counter()
        setup_s = t_start - ctx.t0
        ctx.log("[setup] " + ", ".join(f"{k} {b - a:.2f} s" for (_, a), (k, b) in
                                       zip([("start", ctx.t0)] + marks, marks)))
        first = len(feed.sizes)
        before = usage()
        ends = [_event(dev)]
        data_time = []
        deadline = t_start + ctx.seconds
        while time.perf_counter() < deadline:
            data_time.append(step()["data_time"][0])
            ends.append(_event(dev))
        sync(dev)
        wall = time.perf_counter() - t_start
        ctx.log(usage_line(before, wall))
        steps = len(ends) - 1
        # each step's time between the CUDA events at its ends; none
        # off the card
        step_ms = [a.elapsed_time(b) for a, b in zip(ends[:-1], ends[1:])] \
            if dev.type == "cuda" else []
        window_flops = sum(model_fam.train_flops(b, st) for b in feed.sizes[first:])
        if step_ms:
            ctx.log(f"[window] step ms median {statistics.median(step_ms):.2f}, p90 "
                    f"{np.percentile(step_ms, 90):.2f}, max {max(step_ms):.2f}")
        ctx.log(f"[window] {steps} steps in {wall:.3f} s; data_time median "
                f"{1e3 * statistics.median(data_time):.2f} ms; set-up {setup_s:.2f} s")

        observed = None
        if ctx.trace:
            observed = _traced(ctx, step, model_fam, st, dev)
            observed.window_flops, observed.window_s = window_flops, wall
            observed.data_time, observed.step_ms = data_time, step_ms
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    feed.stream.close()
    del trainer, model, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    # the reference follows the system's mined seeds (a near-tie of random
    # weights' scores flips under rounding), and checks the mining by itself
    per_step = len(mining) // n_check
    seeds = [[c["seeds"] for c in mining[s * per_step:(s + 1) * per_step]]
             for s in range(n_check)]
    ref_losses, ref_grads, ref_change, _, ref_look = model_fam.reference_train(
        dicts, tree, weights_mod.make(shapes, cell.config["init"], ctx.seed, dev), n_check, dev,
        seeds=seeds)
    checks = compare.train_numbers(prog_losses, prog_grads, prog_change, ref_losses, ref_grads,
                                   ref_change)
    checks["mining_gap"] = model_fam.mining_gap(mining, tree)
    ctx.log(f"[check] losses {prog_losses} vs reference {ref_losses}; reference "
            f"{time.perf_counter() - t_ref:.1f} s; numbers {checks}")
    _widest(ctx, "[check]", prog_grads, ref_grads, prog_change, ref_change)
    seed_look = model_fam.seed_look(mining, ref_look, n_check)
    ctx.log("[check] seed weights' largest relative gap from the reference's scores, "
            "foreground proposals a step, by branch: " +
            "; ".join(f"{i} {b['weight_gap']:.4g} {b['fg']}" for i, b in enumerate(seed_look)))
    look = None
    if ctx.look:
        # the reference again, following the system's seed weights too
        seeds = [[(*c["seeds"], c["weights"]) for c in mining[s * per_step:(s + 1) * per_step]]
                 for s in range(n_check)]
        again = model_fam.reference_train(
            dicts, tree, weights_mod.make(shapes, cell.config["init"], ctx.seed, dev), n_check,
            dev, seeds=seeds)
        look = {"seed_look": seed_look,
                "weights_followed": compare.train_numbers(prog_losses, prog_grads, prog_change,
                                                          *again[:3]),
                "widest": _widest(ctx, "[look] weights followed:", prog_grads, again[1],
                                  prog_change, again[2])}
    out = {"end_to_end": {"train_img_per_s": steps * cfg.SOLVER.IMS_PER_BATCH / wall,
                          "setup_s": setup_s},
           "numbers": checks, "attempted": steps, "failed": 0,
           "device": device_line(dev, 1, peak), "observed": observed, "look": look}
    if observed is not None:
        out.update(busy_s=observed.trace.busy_s(), window_s=observed.trace.wall_s,
                   breakdown=observed.breakdown())
    return out


def _widest(ctx, tag, prog_grads, ref_grads, prog_change, ref_change) -> Dict[str, List]:
    """Logs, and returns, the four leaves of the widest gaps of the first
    gradient's and of the change's norms (system / reference)."""
    out = {}
    for label, prog, refr in (("gradient", prog_grads, ref_grads), ("change", prog_change,
                                                                       ref_change)):
        floor = statistics.median(refr.values())
        worst = sorted(refr, key=lambda k: -abs(prog[k] - refr[k]) / max(refr[k], floor))[:4]
        out[label] = [(k, prog[k], refr[k]) for k in worst]
        ctx.log(f"{tag} {label} norms, median leaf {floor:.4g}; widest gaps: " +
                ", ".join(f"{k} {prog[k]:.5g} / {refr[k]:.5g}" for k in worst))
    return out


def _event(dev):
    if dev.type != "cuda":
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _traced(ctx, step, model_fam, st, dev) -> Observed:
    calls: Dict[str, list] = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    n = int(ctx.cell.traffic["trace_steps"])
    with model_fam.recording(calls), torch.profiler.profile(activities=acts) as prof:
        sync(dev)
        t = time.perf_counter()
        for _ in range(n):
            step()
        sync(dev)
        wall = time.perf_counter() - t
    obs = Observed("train", Trace.take(prof, wall, n), calls, st, model_fam)
    ranges = obs.trace.range_host_s(model_fam.TRAIN_RANGES)
    ctx.log("[trace] host ms a step by range: " +
            ", ".join(f"{k} {1e3 * v / n:.2f}" for k, v in ranges.items()) +
            f"; device busy {obs.trace.busy_s():.3f} of {wall:.3f} s")
    return obs
