"""Evaluation traffic: images one at a time through the system's inference
driver, ``engine/defaults.py:inference_on_samples``, a closed loop.

Set-up makes the mix's images from the seed, maps each with the system's
test mapper, builds the model with weights from the seed, and runs each
canvas shape of the mix through the driver twice. The window then cycles
through the mapped images in the driver until ``--seconds`` have passed:
each image's copy to the card, ``predict``, the rescale and the
evaluator's ``process_single`` fall inside it; ``evaluate()`` stays out.
A traced run then profiles ``trace_images`` more images. Once the
program's state is freed, the plain reference recomputes a sample of the
window's images, drawn from the seed, from the raw images and the same
weights.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import synth, weights as weights_mod
from ..trace import Trace
from .common import Observed, device_line, sync, usage, usage_line


class Recorder:
    """An evaluator that keeps what the driver hands ``process_single``
    (the system's detections of each image, in order) and passes it on."""

    def __init__(self, inner):
        self.inner = inner
        self.seen: List[tuple] = []

    def process_single(self, image_id, boxes, scores, classes, valid=None):
        self.seen.append((boxes, scores, classes, valid))
        self.inner.process_single(image_id, boxes, scores, classes, valid)


def _until(samples: List[dict], deadline: float):
    i = 0
    while time.perf_counter() < deadline:
        yield samples[i % len(samples)]
        i += 1


def run(ctx) -> Dict:
    from sos_wsod_torch.data.build import DatasetMapperTest
    from sos_wsod_torch.data.voc import CLASS_NAMES
    from sos_wsod_torch.engine.defaults import inference_on_samples
    from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator

    cell, mix, dev = ctx.cell, ctx.cell.traffic, torch.device(ctx.device)
    fam = cell.model()
    cfg = ctx.port_cfg()
    tree = cfg.to_dict()
    st = fam.settings(tree)
    shapes = fam.param_shapes(st)
    marks = [("imports", time.perf_counter())]
    dicts = synth.dataset_dicts(mix, st["num_classes"], ctx.seed)
    marks.append(("inputs", time.perf_counter()))
    mapper = DatasetMapperTest.from_cfg(cfg)
    samples = [mapper(d) for d in dicts]
    marks.append(("mapping", time.perf_counter()))
    model = fam.build(cfg, weights_mod.make(shapes, cell.config["init"], ctx.seed, dev), dev)
    marks.append(("model", time.perf_counter()))

    def evaluator():
        return PascalVOCDetectionEvaluator("voc_2007_test", {}, CLASS_NAMES)

    first_of_shape = {}
    for s in samples:
        first_of_shape.setdefault(s["image"].shape, s)
    for _ in range(2):
        inference_on_samples(model, list(first_of_shape.values()), evaluator(), dev)
    marks.append(("warm-up", time.perf_counter()))

    rec = Recorder(evaluator())
    with fam.capture(model, len(samples)) as kept:
        sync(dev)
        t_start = time.perf_counter()
        before = usage()
        setup_s = t_start - ctx.t0
        ctx.log("[setup] " + ", ".join(f"{k} {b - a:.2f} s" for (_, a), (k, b) in
                                       zip([("start", ctx.t0)] + marks, marks)))
        n = inference_on_samples(model, _until(samples, t_start + ctx.seconds), rec, dev)
        sync(dev)
        wall = time.perf_counter() - t_start
    ctx.log(usage_line(before, wall))
    window_flops = sum(fam.predict_flops(samples[i % len(samples)], st) for i in range(n))
    ctx.log(f"[window] {n} images in {wall:.3f} s; set-up {setup_s:.2f} s")

    observed = None
    if ctx.trace:
        k = int(mix["trace_images"])
        calls: Dict[str, list] = {}
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with fam.recording(calls), torch.profiler.profile(activities=acts) as prof:
            sync(dev)
            t = time.perf_counter()
            inference_on_samples(model, samples[:k], evaluator(), dev)
            sync(dev)
            traced_wall = time.perf_counter() - t
        observed = Observed("infer", Trace.take(prof, traced_wall, k), calls, st, fam,
                            window_flops=window_flops, window_s=wall)
        ctx.log(f"[trace] {k} images in {traced_wall:.3f} s; device busy "
                f"{observed.trace.busy_s():.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # a sample of the window's images, drawn from the seed: distinct images,
    # each at its last pass in the window
    rng = np.random.default_rng([int(ctx.seed), 1])
    k = min(int(mix["check_images"]), len(samples), n)
    picks = {int(i): int(i) + len(samples) * ((n - 1 - int(i)) // len(samples))
             for i in rng.choice(min(n, len(samples)), k, replace=False)}
    t_ref = time.perf_counter()
    w = weights_mod.make(shapes, cell.config["init"], ctx.seed, dev)
    program = {}
    for i, it in picks.items():
        boxes, scores, classes, valid = rec.seen[it]
        valid = np.ones(len(scores), bool) if valid is None else np.asarray(valid, bool)
        program[i] = ((boxes[valid], scores[valid], classes[valid]),
                      None if kept is None else kept[i])
    refs = fam.reference_predict({i: dicts[i] for i in picks}, tree, w, dev,
                                 proposals=None if kept is None else
                                 {i: program[i][1] for i in picks})
    checks = fam.check_numbers(program, refs, list(picks))
    ctx.log(f"[check] {k} images; reference {time.perf_counter() - t_ref:.1f} s; numbers "
            f"{checks}")
    out = {"end_to_end": {"infer_img_per_s": n / wall, "setup_s": setup_s},
           "numbers": checks, "attempted": n, "failed": 0,
           "device": device_line(dev, 1, peak), "observed": observed}
    if observed is not None:
        out.update(busy_s=observed.trace.busy_s(), window_s=observed.trace.wall_s,
                   breakdown=observed.breakdown())
    return out
