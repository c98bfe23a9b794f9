#!/usr/bin/env python3
"""Warm throughput of the port's stage-2/3 inference (R50-FPN Faster R-CNN,
``GeneralizedRCNN.predict``) on one GPU.

    python -m sos_wsod_torch.tools.profile_stage2 [--images 16] [--runs 5]

Builds configs/stage23/voc_baseline.yaml at full width with random weights
from a seed, in bf16 as the configuration runs, writes ``--images``
synthetic 375x500 VOC images into a temporary directory and loads them with
the stage-1 test mapper (704x960 canvas), warms up with one pass, then times
``--runs`` passes (host to device copy and predict of every image, the
device synchronized at the end) and prints images/sec of each, their median
and spread, and the NMS and ROIAlign kernel launches an image.

The script imports the package by absolute name, so it can time another
checkout's package: ``PYTHONPATH=OTHER python3 PATH/TO/profile_stage2.py``
with a working directory outside this one. Compare two versions in turns,
each process alone, within one machine.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import statistics
import subprocess
import tempfile
import time

import torch

import sos_wsod_torch
from sos_wsod_torch.data.build import build_stage1_test_loader
from sos_wsod_torch.data.datasets.voc import register_all_voc
from sos_wsod_torch.engine.synthetic import build_synthetic_frcnn, load_config, write_synthetic_voc
from sos_wsod_torch.kernels import nms as nms_kernel
from sos_wsod_torch.kernels import roi_align as align_kernel

CONFIG = pathlib.Path(sos_wsod_torch.__file__).resolve().parents[1] / "configs" / "stage23" / \
    "voc_baseline.yaml"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_voc(tmp, (("test", args.images),), (375, 500), 8, args.seed)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            cfg = load_config(str(CONFIG))
            model = build_synthetic_frcnn(cfg, device, args.seed)
            register_all_voc()
            samples = list(build_stage1_test_loader(cfg, "voc_2007_test"))
        finally:
            os.chdir(cwd)
    print(f"[setup] {len(samples)} images {tuple(samples[0]['image'].shape)} and the model "
          f"({model.compute_dtype}) from {sos_wsod_torch.__file__} in "
          f"{time.perf_counter() - t0:.1f} s; {smi}; torch {torch.__version__}", flush=True)

    def one_pass():
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            for s in samples:
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in s.items() if k != "image_id"}
                model.predict(batch)
        torch.cuda.synchronize()

    one_pass()   # cold: cuDNN plans, kernel builds
    nms_kernel.sweep_launches, align_kernel.launches = 0, 0
    rates = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pass()
        rates.append(len(samples) / (time.perf_counter() - t0))
    n = args.runs * len(samples)
    print(f"[throughput] stage-2 predict, {len(samples)} images x {args.runs} runs, warm: "
          f"{' '.join(f'{r:.3f}' for r in rates)} img/s; median {statistics.median(rates):.3f}, "
          f"spread {min(rates):.3f}-{max(rates):.3f}; launches an image: NMS "
          f"{nms_kernel.sweep_launches / n:g}, ROIAlign {align_kernel.launches / n:g} ({smi})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
