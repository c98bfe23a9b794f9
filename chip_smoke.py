#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sos_wsod_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the stage-1 inference path with
     nvcc from the sources in this checkout (into build/sos_wsod_torch/);
  3. kernel vs plain: the ROIPool kernel against its plain PyTorch version at
     the production shape, bf16 and f32, bit-identical out and argmax, with
     median CUDA-event times of both;
  4. slice: the full-width VGG16 OICR+ model of
     configs/stage1/voc07_oicr_plus.yaml with random weights made from a
     seed, 4 synthetic VOC-sized images through run_stage1_inference in bf16
     into the VOC evaluator, which writes the detection-result JSON; checks
     the JSON and the kernel's launch count, holds the kernel against the
     plain pool on a real backbone feature, and the bf16 outputs against an
     f32 run of the same model (the kernel's f32 path).
The images/sec it prints are a smoke reading over 4 images with evaluate()
and the JSON write inside the window; tools/profile_torch_inference.py
measures the throughput baseline.
Then one JSON line per kernel and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml"
FEAT_HWC = (87, 119, 512)      # plain5 of a 688x917 image on its 704x960 canvas
NUM_PROPOSALS, CAPACITY = 4000, 4096
RAW_HW = (375, 500)            # a typical VOC07 image
NUM_IMAGES = 4
SEED = 0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from sos_wsod_torch.kernels import build

    stale = build.library_path("roi_pool_fwd")
    stale.unlink(missing_ok=True)   # build from the sources, not a cached library
    t0 = time.perf_counter()
    lib = build.build("roi_pool_fwd")
    secs = time.perf_counter() - t0
    report = lib.with_name(lib.name + ".log").read_text()
    ptxas = " ".join(l.split("ptxas info    : ")[-1] for l in report.splitlines()
                     if "registers" in l or "spill" in l)
    log("build", f"roi_pool_fwd.cu -> {lib.relative_to(ROOT)} in {secs:.2f} s; {ptxas}")


def _cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_same(name: str, out_k, pos_k, out_p, pos_p) -> float:
    if not torch.equal(_bits(out_k), _bits(out_p)):
        n = int((_bits(out_k) != _bits(out_p)).sum())
        raise AssertionError(f"{name}: kernel output differs from the plain version in {n} elements")
    if pos_k is not None and not torch.equal(pos_k, pos_p):
        n = int((pos_k != pos_p).sum())
        raise AssertionError(f"{name}: kernel argmax differs from the plain version in {n} elements")
    return float((out_k.float() - out_p.float()).abs().max())


def production_pool_inputs(device):
    """Random plain5-sized features with a constant tie plateau, 4000 random
    proposals padded to 4096 plus whole-image, sub-cell, corner and sliver
    boxes, and objectness scales in [1, 2]."""
    rng = np.random.RandomState(SEED)
    h, w, c = FEAT_HWC
    feat = rng.randn(h, w, c).astype(np.float32)
    feat[10:30, 20:50] = 1.5                          # tie plateau
    img_h, img_w = 688, 917
    x1 = rng.uniform(0, img_w - 10, CAPACITY)
    y1 = rng.uniform(0, img_h - 10, CAPACITY)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(2, img_w / 2, CAPACITY), img_w),
                      np.minimum(y1 + rng.uniform(2, img_h / 2, CAPACITY), img_h)], 1)
    boxes[:5] = [[0, 0, img_w, img_h], [5, 5, 6, 6], [img_w - 4, img_h - 4, img_w, img_h],
                 [0, 0, 3, img_h], [160, 80, 400, 240]]   # the last lies on the plateau
    valid = np.arange(CAPACITY) < NUM_PROPOSALS
    rs = rng.uniform(1, 2, CAPACITY).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(feat), t(boxes.astype(np.float32)), t(valid), t(rs)


def phase_kernel_vs_plain(device) -> dict:
    from sos_wsod_torch.kernels.roi_pool import roi_pool_fwd_cuda
    from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool_reference

    feat32, boxes, valid, rs = production_pool_inputs(device)
    h, w, _ = FEAT_HWC
    win = bin_windows(boxes, valid, h, w, 7, 7, 1.0 / 8)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        feat = feat32.to(dtype)
        out_k, pos_k = roi_pool_fwd_cuda(feat, *win, valid, rs)
        out_p, pos_p = roi_pool_reference(feat, *win, valid, rs)
        torch.cuda.synchronize()
        err = _assert_same(f"roi_pool {dtype}", out_k, pos_k, out_p, pos_p)
        # the options the main path does not take: no scale, no argmax
        out_n, no_pos = roi_pool_fwd_cuda(feat, *win, valid, None, return_argmax=False)
        assert no_pos is None
        _assert_same(f"roi_pool {dtype} no scale", out_n, None,
                     roi_pool_reference(feat, *win, valid, None)[0], None)
        ms = _cuda_ms(lambda: roi_pool_fwd_cuda(feat, *win, valid, rs), 20)
        plain_ms = _cuda_ms(lambda: roi_pool_reference(feat, *win, valid, rs), 3)
        live = int((pos_p[..., 0] >= 0).sum())
        log("kernel", f"roi_pool_fwd {str(dtype)[6:]} feat {tuple(feat.shape)} P={CAPACITY}: "
                      f"bit-identical out+argmax ({live} live bins); kernel {ms:.3f} ms, "
                      f"plain {plain_ms:.3f} ms")
        result[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result[torch.bfloat16]


def phase_slice(device, smi: str) -> int:
    from sos_wsod_torch.data.voc import CLASS_NAMES
    from sos_wsod_torch.engine.defaults import run_stage1_inference
    from sos_wsod_torch.engine.synthetic import build_synthetic_slice
    from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator
    from sos_wsod_torch.kernels import roi_pool as roi_pool_kernel
    from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool_reference

    t0 = time.perf_counter()
    _, model, samples, annotations = build_synthetic_slice(
        str(CONFIG), device, NUM_IMAGES, RAW_HW, NUM_PROPOSALS, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log("slice", f"model {n_params / 1e6:.1f}M params ({model.compute_dtype}) and "
                 f"{NUM_IMAGES} images {tuple(samples[0]['image'].shape)} ready in "
                 f"{time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        json_path = pathlib.Path(tmp) / "oicr_plus_voc_2007_test.json"

        def evaluator():
            return PascalVOCDetectionEvaluator(
                "voc_2007_test", annotations, CLASS_NAMES, save_detection_result=True,
                save_path=str(json_path.parent / "oicr_plus_{}.json"))

        roi_pool_kernel.launches = 0
        times = []
        for _ in range(2):   # first pass cold (cuDNN plans), second warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run_stage1_inference(model, [dict(s) for s in samples], evaluator(), device)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = roi_pool_kernel.launches
        if launches < 2 * NUM_IMAGES:
            raise AssertionError(f"ROIPool kernel launched {launches} times for "
                                 f"{2 * NUM_IMAGES} images")
        dets = json.loads(json_path.read_text())
    if not dets:
        raise AssertionError("the detection-result JSON is empty")
    vals = np.array([[d["score"], *d["bbox"]] for d in dets], np.float64)
    if not np.isfinite(vals).all():
        raise AssertionError("non-finite score or box in the detection-result JSON")
    per_image = {i: sum(d["image_id"] == i for d in dets) for i in range(1000, 1000 + NUM_IMAGES)}
    log("slice", f"run_stage1_inference: {len(dets)} detections {per_image}, "
                 f"AP50 {results['bbox']['AP50']:.3f}; smoke reading (4 images, evaluate() and "
                 f"JSON included): cold {NUM_IMAGES / times[0]:.2f} img/s, "
                 f"warm {NUM_IMAGES / times[1]:.2f} img/s on {smi}; "
                 f"ROIPool kernel launches {launches}")

    # the main path's pool on a real backbone feature: kernel vs plain, and
    # the bf16 outputs against an f32 run of the same image
    batch = {k: torch.as_tensor(v, device=device) for k, v in samples[0].items() if k != "image_id"}
    with torch.inference_mode():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feat = model.backbone_features(batch["image"], batch["valid_hw"])
            _, scores16, boxes16 = model.predict(batch)
        obn = batch["objectness"] + 1.0
        pooled = model._pool(feat, batch["boxes"], batch["prop_valid"], obn)
        h, w, _ = feat.shape
        win = bin_windows(batch["boxes"], batch["prop_valid"], h, w, 7, 7, 1.0 / model.stride)
        ref, _ = roi_pool_reference(feat, *win, batch["prop_valid"], obn)
        _assert_same("slice pool", pooled, None, ref, None)
        _, scores32, boxes32 = model.predict(batch)
    ds = float((scores16 - scores32).abs().max())
    db = float((boxes16 - boxes32).abs().max())
    if not (torch.isfinite(scores16).all() and torch.isfinite(boxes16).all()):
        raise AssertionError("non-finite bf16 scores or boxes")
    if ds > 1e-2 or db > 2.0:
        raise AssertionError(f"bf16 vs f32: scores differ by {ds}, boxes by {db}")
    log("slice", f"feat {tuple(feat.shape)} {feat.dtype}: slice pool kernel == plain; "
                 f"bf16 vs f32 max |d score| {ds:.2e}, max |d box| {db:.3f} px")
    return launches


def main() -> int:
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    kernel = phase_kernel_vs_plain(device)
    launches = phase_slice(device, smi)
    print(json.dumps({"kernels": [{
        "name": "roi_pool_fwd", "route": "cuda",
        "source": "sos_wsod_torch/csrc/roi_pool_fwd.cu",
        "replaces": "sos_wsod_tpu/ops/pallas/roi_pool_fused.py:240",
        "launches": launches, **kernel}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
