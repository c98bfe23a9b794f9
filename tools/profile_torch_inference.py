#!/usr/bin/env python3
"""Throughput and time breakdown of the PyTorch port's stage-1 inference on
one GPU.

    python3 tools/profile_torch_inference.py [--images 200] [--runs 3]
                                             [--profile-images 8] [--trace PATH]

Builds the full-width VGG16 OICR+ model of configs/stage1/voc07_oicr_plus.yaml
with random weights from a seed and ``--images`` synthetic VOC-sized images
(375x500 raw, resized to 688x917 on a 704x960 canvas, 4000 proposals in 4096
slots), warms up, then prints:
  1. throughput: ``--runs`` timed passes of inference_on_samples over all the
     images (host to device copy, predict, rescale and the evaluator's
     per-image work; evaluate() and the JSON write stay outside the window),
     images/sec of each, their median and spread;
  2. a torch.profiler window over ``--profile-images`` images: per image, the
     host time and the device kernel time of each profiler range of the path
     (h2d, backbone, roi_pool, box_head, nms_topk, rescale_eval; the ROIPool
     kernel's time comes from its own row), the device
     busy share (kernel time / wall), the NMS fixpoint iterations
     (aten::equal calls) and the top device kernels.
With --trace, also writes the profiler's Chrome trace to PATH.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sos_wsod_torch.data.voc import CLASS_NAMES  # noqa: E402
from sos_wsod_torch.engine.defaults import inference_on_samples  # noqa: E402
from sos_wsod_torch.engine.synthetic import build_synthetic_slice  # noqa: E402
from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator  # noqa: E402

CONFIG = ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml"
RANGES = ("h2d", "backbone", "roi_pool", "box_head", "nms_topk", "rescale_eval")
# Kernels launched through ctypes from a library with its own (static) CUDA
# runtime: the profiler records them but ties them to no host op, so their
# time is added to the range they run in by name.
CTYPES_KERNELS = {"roi_pool": "roi_pool_fwd_kernel"}


def _is_kernel(evt) -> bool:
    return evt.device_type == DeviceType.CUDA and not evt.is_user_annotation


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--profile-images", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="", help="write the Chrome trace here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _, model, samples, annotations = build_synthetic_slice(
        str(CONFIG), device, args.images, (375, 500), 4000, args.seed)
    print(f"[setup] {len(samples)} images {samples[0]['image'].shape} and the model in "
          f"{time.perf_counter() - t0:.1f} s; {smi}; torch {torch.__version__}", flush=True)

    def evaluator():
        return PascalVOCDetectionEvaluator("voc_2007_test", annotations, CLASS_NAMES)

    inference_on_samples(model, samples[:8], evaluator(), device)   # warm-up

    rates = []
    for _ in range(args.runs):
        ev = evaluator()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = inference_on_samples(model, samples, ev, device)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    print(f"[throughput] {len(samples)} images x {args.runs} runs, warm, evaluate() outside "
          f"the window: {' '.join(f'{r:.3f}' for r in rates)} img/s; median "
          f"{statistics.median(rates):.3f}, spread {min(rates):.3f}-{max(rates):.3f} ({smi})",
          flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    window = samples[:args.profile_images]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_on_samples(model, window, evaluator(), device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    n = len(window)
    print(f"[layers] per image, {n} images in the profiler window, ms ({smi}):")
    print(f"  {'range':13s} {'host':>9s} {'device':>9s}")
    for name in RANGES:
        rows = [e for e in avgs if e.key == name and e.device_type == DeviceType.CPU]
        host = sum(e.cpu_time_total for e in rows) / n / 1e3
        dev = sum(e.device_time_total for e in rows)
        if name in CTYPES_KERNELS:
            dev += sum(e.self_device_time_total for e in avgs
                       if _is_kernel(e) and CTYPES_KERNELS[name] in e.key)
        dev = dev / n / 1e3
        print(f"  {name:13s} {host:9.3f} {dev:9.3f}")
    busy_us = sum(e.self_device_time_total for e in avgs if _is_kernel(e))
    iters = sum(e.count for e in avgs if e.key == "aten::equal")
    print(f"[profile] {n} images in {wall_us / 1e3:.1f} ms wall ({n * 1e6 / wall_us:.2f} img/s "
          f"with the profiler on); device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / wall_us:.1f}%); NMS fixpoint iterations {iters} "
          f"({iters / n:.1f}/image)")
    kernels = sorted((e for e in avgs if _is_kernel(e)), key=lambda e: e.self_device_time_total,
                     reverse=True)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    if args.trace:
        pathlib.Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
