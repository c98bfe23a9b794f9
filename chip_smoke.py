#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sos_wsod_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the stage-1 and stage-2 paths with
     nvcc from the sources in this checkout (into build/sos_wsod_torch/), one
     nvcc per source, all started together;
  3. forward kernel vs plain: the ROIPool forward kernel against its plain
     PyTorch version at the production shape and the top training map, bf16
     and f32, bit-identical out and argmax, with and without pos and scale;
     median CUDA-event times with pos (the training call) and without (the
     inference call) beside the bound, and the plain version's time at the
     production shape;
  4. backward kernel vs plain: the ROIPool backward kernel on the forward
     kernel's argmax at the production shape and the top training map, bf16
     and f32, bit-identical to its plain version run on the CPU and to itself
     across two launches; the bin-tile pairs it visits and the bytes it
     reads for them; median times beside the bound, the plain version's and
     index_add_'s alone on precomputed flat indices;
  4b. NMS kernels vs plain: the greedy NMS kernels (bitmasks + sweep)
     against the plain fixpoint at the four shapes the port runs them
     (sos_wsod_torch/tools/bench_nms.py: stage-1 inference 20 x 4096, mining
     1 x 1024, the stage-2 RPN 1 x 4495, the box head 20 x 1000), on boxes
     with chains of suppression, exact ties of score and IoU, and on the
     reference golden nms.npz: bit-identical keep masks; the two kernels as
     a caller waits for them (the JSON line's ms) and the mask kernel's and
     the sweep's device times alone, beside the bound
     (operations of the pairs the inputs need, or bytes) and the plain
     version's time;
  4c. ROIAlign kernel vs plain: the multi-level ROIAlign forward at the FPN
     shapes (p2-p5 of 704 x 960 x 256, 1000 ROIs; bench_roi_align.py), bf16
     and f32, torch.equal; times as called and on the device beside the
     bound (bytes or operations) and the plain version's; then its
     adversarial cases (whole-map ROIs, sample cap 16, fixed ratios, V1,
     3 and 12 channels, long ROIs on a 1344-wide canvas), each torch.equal,
     with the ROIs of each branch (staged in shared memory or direct);
  5. inference slice: the full-width VGG16 OICR+ model of
     configs/stage1/voc07_oicr_plus.yaml with random weights made from a
     seed, 4 synthetic VOC-sized images through run_stage1_inference in bf16
     into the VOC evaluator, which writes the detection-result JSON; checks
     the JSON and the ROIPool and NMS kernels' launch counts, holds the pool
     kernel against the plain pool on a real backbone feature, the
     detections against one pass with the plain NMS, and the bf16 outputs
     against an f32 run of the same model (the kernel's f32 path);
  6. training slice: the same full-width model in train mode (dropout 0.5,
     bf16 autocast, SOLVER.IMS_PER_BATCH 1), synthetic 375x500 dataset dicts
     with 4000 proposals through DatasetMapperMultiInput (in the config's
     DATALOADER.NUM_WORKERS threads) and batched_stream into
     Stage1Trainer.train for a few steps; checks every loss and metric key
     at each step, 4 forward and 4 backward kernel launches per step,
     trained weights moved and frozen ones unchanged, and one step's bf16
     losses against f32 (dropout off); prints step times, canvases, peak
     memory, and over 2 warm profiled steps the device time of each profiler
     range and the NMS kernel launches of each mining round;
  7. gather: the row-gather microbenchmark (python -m
     sos_wsod_torch.tools.bench_gather) at its default shape, 2^20 random
     rows of 512 bf16 from a 2,871,180-row table, the kernel bit-identical
     to index_select, with median CUDA-event times of both; then a ragged
     row count (2^20 - 37) and f32 at 2^18 rows, bit-identical;
  8. CLI: a synthetic VOC tree on disk (8 train, 4 val, 4 test 375x500
     JPEGs with XMLs and 4000 proposals each in detectron2 pickles) through
     the stage-1 CLI (sos_wsod_torch.tools.train_net_stage1.main, in this
     process) at full width: 4 steps with checkpoints every 2 and evals
     every 2, then --resume to 6 steps, then --eval-only writing the
     detection-result JSON; checks the files, the eval scalars, the resumed
     iterations, the strict checkpoint load, the JSON and the kernel
     launches of each step and eval, and prints step times;
  9. stage-2 inference slice: the full-width R50-FPN Faster R-CNN of
     configs/stage23/voc_baseline.yaml (random weights from a seed,
     engine/synthetic.py) over 4 synthetic 375x500 images of a VOC tree on
     disk through build_stage1_test_loader (688 x 917 on a 704 x 960 canvas),
     GeneralizedRCNN.predict in bf16; checks 1 ROIAlign and 2 NMS launches an
     image (the RPN's and the box head's), finite detections, one image's
     detections against the all-plain path (plain NMS and ROIAlign), and
     prints warm img/s and, over 2 profiled images, the host and device ms of
     each range (backbone, rpn, roi_align, box_head, nms_topk) with the
     device's busy share;
 10. stage-2 CLI: a stage-2 checkpoint from the seeded initializer, then
     sos_wsod_torch.tools.train_net_unbias --eval-only in this process at full
     width on the same tree; prints the detection count and AP50.
The images/sec it prints are smoke readings: 4 inference images with
evaluate() and the JSON write inside the window, and a few training steps;
tools/profile_torch_inference.py measures the stage-1 inference throughput.
Then one JSON line with the kernels (each with its launches on the main
path, its time, the plain version's, the bound and the library call's where
there is one), the card's line and, last, {"ok": true, "device": {...}}.
A bound is the larger of the bytes the function must move, each input read
once and each output written once, over the H100's 3.35 TB/s of HBM, and its
f32 operations over 67 TFLOP/s. NMS is bound by operations (those of each
kept box against every later kept box, and one test a suppressed box);
ROIAlign's bound is computed from both (9 f32 operations for each channel of
each sample of each valid ROI's grid); every other kernel here is bound by
bytes (its operations are compares and adds).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import pathlib
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd import DeviceType

from sos_wsod_torch.tools.bench_roi_pool import (
    CAPACITY, FEAT_HWC, NUM_PROPOSALS, TOP_FEAT_HWC, fwd_traffic_bytes, production_pool_inputs,
    window_cells)
from sos_wsod_torch.tools.measure import bound_ms, card_line, cuda_ms

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "stage1" / "voc07_oicr_plus.yaml"
RAW_HW = (375, 500)            # a typical VOC07 image
NUM_IMAGES = 4
TRAIN_STEPS = 4
SEED = 0
KERNELS = ("roi_pool_fwd", "roi_pool_bwd", "gather_rows", "nms", "roi_align_fwd")
GATHER_TABLE_ROWS, GATHER_C = 2871180, 512
CLI_SPLITS = (("train", 8), ("val", 4), ("test", 4))
RANGES = ("h2d", "backbone", "roi_pool", "box_head", "mining", "losses", "backward",
          "optimizer")
STAGE2_CONFIG = ROOT / "configs" / "stage23" / "voc_baseline.yaml"
STAGE2_RANGES = ("h2d", "backbone", "rpn", "roi_align", "box_head", "nms_topk")
ADVERSARIAL_LIMIT_S = 60       # each ROIAlign adversarial case, plain version included


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = card_line()
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from sos_wsod_torch.kernels import build

    def one(name):
        build.library_path(name).unlink(missing_ok=True)   # build from the sources
        t0 = time.perf_counter()
        lib = build.build(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as ex:
        done = list(ex.map(one, KERNELS))
    for name, (lib, secs) in zip(KERNELS, done):
        report = lib.with_name(lib.name + ".log").read_text()
        ptxas = " ".join(line.split("ptxas info    : ")[-1] for line in report.splitlines()
                         if "registers" in line or "spill" in line)
        log("build", f"{name}.cu -> {lib.relative_to(ROOT)} in {secs:.2f} s; {ptxas}")


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


def phase_kernel_vs_plain(device) -> dict:
    from sos_wsod_torch.kernels.roi_pool import roi_pool_fwd_cuda
    from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool_reference
    from sos_wsod_torch.tools.bench_roi_pool import check

    def wrapper(feat, win, valid, rs, with_pos):
        return roi_pool_fwd_cuda(feat, *win, valid, rs, return_argmax=with_pos)

    result = {}
    for hwc in (FEAT_HWC, TOP_FEAT_HWC):
        feat32, boxes, valid, rs = production_pool_inputs(device, hwc, SEED)
        h, w, c = hwc
        win = bin_windows(boxes, valid, h, w, 7, 7, 1.0 / 8)
        window_gb = window_cells(*win, valid) * c / 1e9
        for dtype in (torch.bfloat16, torch.float32):
            feat = feat32.to(dtype)
            # with pos and scale (training), without pos (inference), without scale
            err = check({"roi_pool_fwd_cuda": wrapper}, feat, win, valid, rs)
            ms = cuda_ms(lambda: roi_pool_fwd_cuda(feat, *win, valid, rs), 20)
            ms_nopos = cuda_ms(
                lambda: roi_pool_fwd_cuda(feat, *win, valid, rs, return_argmax=False), 20)
            isz = feat.element_size()
            bound = bound_ms(fwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, isz, True))
            bound_nopos = bound_ms(fwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, isz, False))
            plain_ms = (cuda_ms(lambda: roi_pool_reference(feat, *win, valid, rs), 3)
                        if hwc == FEAT_HWC else None)
            log("kernel", f"roi_pool_fwd {str(dtype)[6:]} feat {hwc} P={CAPACITY}: "
                          f"bit-identical out+argmax, without pos, without scale; with pos "
                          f"{ms:.3f} ms (bound {bound:.4f} ms, {100 * bound / ms:.1f}% of it), without pos {ms_nopos:.3f} ms "
                          f"(bound {bound_nopos:.4f} ms, {100 * bound_nopos / ms_nopos:.1f}%); "
                          f"window cells {window_gb * isz:.2f} GB, read at "
                          f"{window_gb * isz / ms:.2f} TB/s" +
                          (f"; plain {plain_ms:.3f} ms" if plain_ms is not None else ""))
            result[(hwc, dtype)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound, "bound_by": "bytes", "library_ms": None}
    return result[(FEAT_HWC, torch.bfloat16)]


def phase_backward_vs_plain(device) -> dict:
    """The backward kernel on the forward kernel's argmax at both maps, bf16
    and f32: bit-identical to the plain version run on the CPU (which adds
    each cell's terms in the kernel's order) and to itself across two
    launches; median times beside the bound, the plain version's time on the
    card and index_add_'s alone on precomputed flat indices."""
    from sos_wsod_torch.kernels.roi_pool_bwd import roi_pool_bwd_cuda, tile_incidences
    from sos_wsod_torch.ops.roi_pool import roi_pool_backward_reference
    from sos_wsod_torch.tools.bench_roi_pool import (
        bwd_inputs, bwd_traffic_bytes, check_bwd, index_add_ms)

    result = {}
    for hwc in (FEAT_HWC, TOP_FEAT_HWC):
        h, w, c = hwc
        for dtype in (torch.bfloat16, torch.float32):
            g, pos, rs_t, win, valid = bwd_inputs(device, hwc, dtype, SEED)
            err = check_bwd({"roi_pool_bwd_cuda": (roi_pool_bwd_cuda, True)}, g, pos, rs_t, win,
                            valid, h, w)
            ms = cuda_ms(lambda: roi_pool_bwd_cuda(g, pos, rs_t, *win, valid, h, w), 20)
            plain_ms = cuda_ms(lambda: roi_pool_backward_reference(g, pos, rs_t, h, w), 5)
            library_ms = index_add_ms(g, pos, rs_t, h, w, 20)
            isz = g.element_size()
            bound_t = bound_ms(bwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, isz))
            pairs = tile_incidences(*win, valid)
            read_gb = pairs * c * (isz + 4) / 1e9
            log("kernel", f"roi_pool_bwd {str(dtype)[6:]} g {tuple(g.shape)} -> {hwc} f32: "
                          f"bit-identical to the plain version on the CPU and across two "
                          f"launches; {pairs} bin-tile pairs, {read_gb:.3f} GB of g and pos "
                          f"read; kernel {ms:.3f} ms (bound {bound_t:.4f} ms, "
                          f"{100 * bound_t / ms:.1f}% of it), plain {plain_ms:.3f} ms, "
                          f"index_add_ {library_ms:.3f} ms")
            result[(hwc, dtype)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "bound_ms": bound_t, "bound_by": "bytes",
                                    "library_ms": library_ms}
            del g, pos
    return result[(FEAT_HWC, torch.bfloat16)]


def _nms_launches() -> int:
    """Launches of the NMS kernels since their counts were last set to 0;
    each call of ops/nms.py runs the mask kernel then the sweep, once each."""
    from sos_wsod_torch.kernels import nms

    if nms.mask_launches != nms.sweep_launches:
        raise AssertionError(f"NMS mask kernel launched {nms.mask_launches} times, the sweep "
                             f"{nms.sweep_launches}")
    return nms.sweep_launches


def _reset_nms_launches() -> None:
    from sos_wsod_torch.kernels import nms

    nms.mask_launches = nms.sweep_launches = 0


@contextlib.contextmanager
def _plain_versions(roi_align: bool = False):
    """Route the card's NMS (and, with ``roi_align``, its ROIAlign) through
    the plain versions, for a comparison with the kernels; never on a
    path whose launches are counted."""
    from sos_wsod_torch.ops import nms as nms_ops
    from sos_wsod_torch.ops import roi_align as align_ops

    saved = nms_ops.nms_keep_sorted_cuda, align_ops.roi_align_fwd_cuda
    nms_ops.nms_keep_sorted_cuda = nms_ops.greedy_keep_sorted_reference
    if roi_align:
        def plain_align(features, boxes, valid, level, scales, **kw):
            out = align_ops.roi_align_levels_reference(features, boxes, valid, level, scales, **kw)
            return out.permute(0, 2, 3, 1)
        align_ops.roi_align_fwd_cuda = plain_align
    try:
        yield
    finally:
        nms_ops.nms_keep_sorted_cuda, align_ops.roi_align_fwd_cuda = saved


def phase_nms_vs_plain(device) -> dict:
    """Kernel C at the four shapes of the port's paths and on the golden:
    keep masks bit-identical to the plain fixpoint; times beside the bound."""
    from sos_wsod_torch.ops.nms import nms_mask
    from sos_wsod_torch.tools import bench_nms

    res = bench_nms.run(device, iters=20, seed=SEED)
    for name, r in res.items():
        log("kernel", f"nms {name} B={r['batch']} S={r['s']} thr={r['thr']}: keep masks "
                      f"bit-identical to the plain fixpoint ({r['kept']} kept, {r['pairs']} "
                      f"pairs); device ms mask {r['mask_ms']:.4f} + sweep {r['sweep_ms']:.4f}, "
                      f"{r['ms']:.4f} ms as called, bound {r['bound_ms']:.4f} ms by "
                      f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of the call, "
                      f"{100 * r['bound_ms'] / r['device_ms']:.1f}% of the device time; bytes "
                      f"{r['bytes_bound_ms']:.5f}, the mask words {r['mask_words_ms']:.4f}), "
                      f"plain {r['plain_ms']:.3f} ms")
    z = np.load(ROOT / "tests" / "goldens" / "nms.npz")
    d = z["dets0"]
    xyxy = torch.from_numpy(np.stack([d[:, 0] - d[:, 2] / 2, d[:, 1] - d[:, 3] / 2,
                                      d[:, 0] + d[:, 2] / 2, d[:, 1] + d[:, 3] / 2], 1)
                            .astype(np.float32)).to(device)
    valid = torch.ones(len(d), dtype=torch.bool, device=device)
    for thr in (0.3, 0.5, 0.7):
        keep = nms_mask(xyxy, torch.from_numpy(z["scores"]).to(device), valid, thr)
        with _plain_versions():
            plain = nms_mask(xyxy, torch.from_numpy(z["scores"]).to(device), valid, thr)
        want = set(z["keep0_%d" % int(thr * 100)].tolist())
        if not torch.equal(keep, plain) or set(torch.nonzero(keep).flatten().tolist()) != want:
            raise AssertionError(f"nms.npz at {thr}: the kernel's keep set differs")
    log("kernel", "nms tests/goldens/nms.npz at 0.3, 0.5, 0.7: the reference's keep sets, "
                  "equal to the plain fixpoint's")
    r = res["stage-1 inference"]
    return {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}


def phase_roi_align_vs_plain(device) -> dict:
    """Kernel D at the FPN shapes, bf16 and f32: torch.equal to the plain
    version; times beside the bound (bytes or operations, whichever binds).
    Then the benchmark's adversarial cases (whole-map ROIs on p2, a sample
    cap of 16, fixed ratios, V1, 3 and 12 channels, long ROIs on a
    1344-wide canvas), each torch.equal to the plain version within
    ADVERSARIAL_LIMIT_S."""
    from sos_wsod_torch.tools import bench_roi_align

    res = bench_roi_align.run(device, iters=20, seed=SEED)
    for dtype, r in res.items():
        log("kernel", f"roi_align_fwd {dtype} p2-p5 of {bench_roi_align.CANVAS} x "
                      f"{bench_roi_align.CHANNELS}, P={bench_roi_align.NUM_ROIS} (per level "
                      f"{r['rois_per_level']}; staged {r['staged']}, direct {r['direct']}): "
                      f"equal to the plain version; kernel {r['ms']:.4f} ms as called, "
                      f"{r['device_ms']:.4f} ms device, bound {r['bound_ms']:.4f} ms by "
                      f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of the call; bytes "
                      f"{r['bytes_bound_ms']:.4f}, operations {r['ops_bound_ms']:.4f}), plain "
                      f"{r['plain_ms']:.3f} ms")
    for dtype in (torch.bfloat16, torch.float32):
        for name, (args, kw) in bench_roi_align.adversarial_cases(device, dtype, SEED).items():
            t0 = time.perf_counter()
            bench_roi_align.check(*args, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if secs > ADVERSARIAL_LIMIT_S:
                raise AssertionError(f"roi_align_fwd {name}: {secs:.1f} s, over "
                                     f"{ADVERSARIAL_LIMIT_S} s")
            b = bench_roi_align.bounds(*args, **kw)
            log("kernel", f"roi_align_fwd {str(dtype)[6:]} {name}: equal to the plain version "
                          f"in {secs:.2f} s (staged {b['staged']}, direct {b['direct']})")
    r = res["bfloat16"]
    return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}


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
        _reset_nms_launches()
        times = []
        for _ in range(2):   # first pass cold (cuDNN plans), second warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run_stage1_inference(model, [dict(s) for s in samples], evaluator(), device)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = roi_pool_kernel.launches
        nms_launches = _nms_launches()
        if launches < 2 * NUM_IMAGES or nms_launches != 2 * NUM_IMAGES:
            raise AssertionError(f"ROIPool kernel launched {launches} times, NMS kernels "
                                 f"{nms_launches} times, for {2 * NUM_IMAGES} images")
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
                 f"ROIPool kernel launches {launches}, NMS kernel launches {nms_launches}")

    # the same images through predict with the kernels and with the plain
    # NMS: every keep mask is bit-identical, so the detections are too
    ms = {"kernel": [], "plain": []}
    for sample in samples:
        batch = {k: torch.as_tensor(v, device=device) for k, v in sample.items()
                 if k != "image_id"}
        out = {}
        for name in ("kernel", "plain"):
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16), \
                    (_plain_versions() if name == "plain" else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[name] = model.predict(batch)[0]
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        for field in ("boxes", "scores", "classes", "valid"):
            if not torch.equal(getattr(out["kernel"], field), getattr(out["plain"], field)):
                raise AssertionError(f"image {sample['image_id']}: detections' {field} differ "
                                     f"between the NMS kernel and the plain NMS")
    log("slice", f"detections with the NMS kernel == with the plain NMS on all "
                 f"{NUM_IMAGES} images; predict ms with the kernel "
                 f"{[round(t, 1) for t in ms['kernel']]}, with the plain NMS "
                 f"{[round(t, 1) for t in ms['plain']]}")

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
    return {"roi_pool_fwd": launches, "nms": nms_launches}


def _kernel_spans(prof, names):
    """Each device kernel of the profile, as (name, device ms, the profiler
    range instance (start, end, name) it ran for, or None), from the
    profiler's raw events: the range whose host interval holds the start of
    the host op the kernel is linked to (its launching op, on any thread); a
    kernel linked to no host op (one launched through ctypes) takes the range
    of the kernel before it on the device, which is the op that prepared its
    inputs."""
    raw = prof.profiler.kineto_results.events()
    host = {e.correlation_id(): e for e in raw if e.device_type() == DeviceType.CPU}
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in raw
                   if e.device_type() == DeviceType.CPU and e.name() in names)
    kernels = sorted((e for e in raw
                      if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()),
                     key=lambda e: e.start_ns())
    out, prev = [], None
    for k in kernels:
        h = host.get(k.linked_correlation_id()) if k.linked_correlation_id() > 0 else None
        if h is not None:
            prev = next((sp for sp in spans if sp[0] <= h.start_ns() <= sp[1]
                         and sp[2] != h.name()), None)
        out.append((k.name(), k.duration_ns() / 1e6, prev))
    return out


def _launches_per_range(prof, kernel_name: str, range_name: str):
    """Launches of ``kernel_name`` within each instance of ``range_name``."""
    counts = {}
    for name, _, span in _kernel_spans(prof, (range_name,)):
        if span is not None:
            counts[span] = counts.get(span, 0) + (kernel_name in name)
    return [counts[s] for s in sorted(counts)]


def _range_ms(prof, names):
    """Host ms of each profiler range (its wall interval on the host), device
    ms of the kernels run for it (``_kernel_spans``; the autograd engine
    launches the backward on its own thread, inside the main thread's
    ``backward`` range), and device ms of the kernels outside every range."""
    host = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.name in host and e.device_type == DeviceType.CPU:
            host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    dev = dict.fromkeys(names, 0.0)
    other = 0.0
    for _, ms, span in _kernel_spans(prof, names):
        if span is None:
            other += ms
        else:
            dev[span[2]] += ms
    return host, dev, other


class _StepProbe:
    """Wraps the batch stream and times each step on the card: records each
    batch, the synchronized wall time, the kernel launches the step added,
    and the scalars the step logged."""

    def __init__(self, stream):
        self.stream = stream
        self.batches, self.times, self.launches, self.scalars = [], [], [], []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.stream)
        self.batches.append(batch)
        return batch

    def hook(self):
        from sos_wsod_torch.engine.hooks import HookBase
        from sos_wsod_torch.kernels import roi_pool as fwd, roi_pool_bwd as bwd

        probe = self

        class Hook(HookBase):
            def before_step(self):
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
                self.counts = (fwd.launches, bwd.launches, _nms_launches())

            def after_step(self):
                torch.cuda.synchronize()
                probe.times.append(time.perf_counter() - self.t0)
                probe.launches.append((fwd.launches - self.counts[0],
                                       bwd.launches - self.counts[1],
                                       _nms_launches() - self.counts[2]))
                probe.scalars.append({k: v for k, (v, it) in self.trainer.storage.latest().items()
                                      if it == self.trainer.iter})

        return Hook()


def _expected_keys(refine_k: int):
    keys = {"loss_cls", "total_loss", "data_time"}
    for k in range(refine_k):
        keys |= {f"loss_cls_r{k}", f"loss_box_reg_r{k}", f"roi_head/num_fg_samples_r{k}",
                 f"roi_head/num_bg_samples_r{k}", f"roi_head/num_ig_samples_r{k}",
                 f"fast_rcnn/cls_accuracy_r{k}", f"fast_rcnn/fg_cls_accuracy_r{k}",
                 f"fast_rcnn/false_negative_r{k}"}
    return keys


def phase_train(device, smi: str) -> dict:
    """The full-width training slice through Stage1Trainer. Returns the
    training run's kernel launch counts."""
    from sos_wsod_torch.data.build import batched_stream
    from sos_wsod_torch.data.mapper_multi import DatasetMapperMultiInput
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_model, load_config, synthetic_train_dicts)
    from sos_wsod_torch.engine.trainer import Stage1Trainer
    from sos_wsod_torch.kernels import roi_pool as fwd, roi_pool_bwd as bwd

    t0 = time.perf_counter()
    override = ["SOLVER.IMS_PER_BATCH", 1]
    cfg = load_config(str(CONFIG), override)
    model = build_synthetic_model(cfg, device, SEED)
    dicts = synthetic_train_dicts(TRAIN_STEPS + 2, RAW_HW, NUM_PROPOSALS,
                                  cfg.MODEL.ROI_HEADS.NUM_CLASSES, SEED)
    probe = _StepProbe(batched_stream(
        dicts, DatasetMapperMultiInput.from_cfg(cfg), cfg.SOLVER.IMS_PER_BATCH,
        seed=max(cfg.SEED, 0), size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        aspect_ratio_grouping=cfg.DATALOADER.ASPECT_RATIO_GROUPING))
    trainer = Stage1Trainer(cfg, model, probe)
    trainer.register_hooks([probe.hook()])
    params = dict(model.named_parameters())
    watch = ("backbone.plain1.conv1.weight", "backbone.plain2.conv2.weight",
             "roi_heads.dan.fc1.weight", "roi_heads.box_refinery_2.cls_score.weight")
    before = {n: params[n].detach().clone() for n in watch}
    log("train", f"override {override} (the reference's one image per GPU); model "
                 f"{sum(p.numel() for p in params.values()) / 1e6:.1f}M params, "
                 f"{sum(p.numel() for p in params.values() if p.requires_grad) / 1e6:.1f}M "
                 f"trained ({model.compute_dtype}, dropout "
                 f"{model.roi_heads.dan.dropout_rate}); mapper in "
                 f"{cfg.DATALOADER.NUM_WORKERS} threads (DATALOADER.NUM_WORKERS); ready in "
                 f"{time.perf_counter() - t0:.1f} s")

    fwd.launches = bwd.launches = 0
    _reset_nms_launches()
    torch.cuda.reset_peak_memory_stats(device)
    trainer.train(0, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {"roi_pool_fwd": fwd.launches, "roi_pool_bwd": bwd.launches,
                "nms": _nms_launches()}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    want = _expected_keys(cfg.WSL.REFINE_NUM)
    for step, scalars in enumerate(probe.scalars):
        if set(scalars) != want or not np.isfinite(list(scalars.values())).all():
            raise AssertionError(f"step {step}: missing {want - set(scalars)}, extra "
                                 f"{set(scalars) - want}, non-finite "
                                 f"{[k for k, v in scalars.items() if not np.isfinite(v)]}")
    if probe.launches != [(4, 4, 4)] * TRAIN_STEPS or launches != {
            "roi_pool_fwd": 4 * TRAIN_STEPS, "roi_pool_bwd": 4 * TRAIN_STEPS,
            "nms": 4 * TRAIN_STEPS}:
        raise AssertionError(f"kernel launches (pool fwd, pool bwd, NMS) per step "
                             f"{probe.launches}, total {launches}")
    for n in watch:
        same = torch.equal(before[n], params[n].detach())
        if same != (".plain1." in n or ".plain2." in n):
            raise AssertionError(f"{n}: {'unchanged' if same else 'moved'} after training")
    for step, (b, t, sc) in enumerate(zip(probe.batches, probe.times, probe.scalars)):
        s = b[0]
        log("train", f"step {step}: {t * 1e3:.1f} ms; canvases s1 {s['images_s1'].shape[1:3]} "
                     f"valid {tuple(s['valid_hw_s1'][0].tolist())}, s2 "
                     f"{s['images_s2'].shape[1:3]} valid {tuple(s['valid_hw_s2'][0].tolist())}; "
                     f"{int(s['prop_valid'].sum())} "
                     f"proposals; total_loss {sc['total_loss']:.4f} loss_cls "
                     f"{sc['loss_cls']:.4f} data_time {sc['data_time'] * 1e3:.1f} ms")
    warm = statistics.median(probe.times[1:])
    log("train", f"{TRAIN_STEPS} steps, 4 fwd + 4 bwd + 4 NMS kernel launches each; fc6 and "
                 f"box_refinery_2 moved, plain1/plain2 bit-identical; smoke reading: warm "
                 f"median {warm * 1e3:.1f} ms/step = {1 / warm:.2f} img/s, first step "
                 f"{probe.times[0] * 1e3:.1f} ms; peak memory {peak_gb:.2f} GB on {smi}")

    # one step's losses, bf16 against f32, dropout off, on the first batch.
    # Bound 1%, set from readings: the sound build read 0.007%, 0.04% and
    # 0.16% in three runs (after 4 steps whose weights differ run to run).
    batch = {k: torch.as_tensor(v, device=device) for k, v in probe.batches[0][0].items()
             if k != "image_id"}
    model.eval()
    with torch.no_grad():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            l16 = model.loss(batch)
        l32 = model.loss(batch)
    model.train()
    shown = ("loss_cls", "loss_cls_r0", "loss_box_reg_r0", "loss_cls_r3", "loss_box_reg_r3")
    pairs = {k: (l16[k].item(), l32[k].item()) for k in shown}
    log("train", "bf16 vs f32, dropout off: " + ", ".join(
        f"{k} {a:.5f} / {b:.5f}" for k, (a, b) in pairs.items()))
    a, b = pairs["loss_cls"]
    if not (np.isfinite(a) and np.isfinite(b)) or abs(a - b) > 0.01 * abs(b):
        raise AssertionError(f"loss_cls bf16 {a} vs f32 {b}: beyond 1%")

    # 2 warm profiled steps: host and device time of each profiler range
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(TRAIN_STEPS, TRAIN_STEPS + 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    probe.stream.close()
    host, per_range, other = _range_ms(prof, RANGES)
    busy = sum(per_range.values()) + other
    canvases = [(b[0]["images_s1"].shape[1:3], b[0]["images_s2"].shape[1:3])
                for b in probe.batches[-2:]]
    log("train", f"ms per step over 2 profiled steps (canvases s1/s2 {canvases}), range "
        f"host/device: " + ", ".join(f"{n} {host[n] / 2:.2f}/{v / 2:.2f}"
                                     for n, v in per_range.items()) +
        f", device outside the ranges {other / 2:.2f}; busy {busy / 2:.1f} of {wall_ms / 2:.1f} ms wall "
        f"({100 * busy / wall_ms:.1f}%, profiler on); data_time "
        f"{[round(sc['data_time'] * 1e3, 1) for sc in probe.scalars[-2:]]} ms; NMS kernel "
        f"launches per mining round {_launches_per_range(prof, 'nms_sweep_kernel', 'mining')}")
    return launches


def phase_gather(device) -> dict:
    """Kernel B's main path, the microbenchmark tool at its default shape
    (which checks bit-identity itself), then the ragged and f32 checks."""
    from sos_wsod_torch.kernels import gather_rows as kernel
    from sos_wsod_torch.tools import bench_gather

    kernel.launches = 0
    res = bench_gather.main([])
    launches = kernel.launches
    log("gather", f"bench_gather defaults (table {GATHER_TABLE_ROWS} x {GATHER_C} bf16, 2^20 "
                  f"rows, blk 512): bit-identical to index_select; kernel {res['ms']:.3f} ms "
                  f"{res['gbs']:.1f} GB/s, index_select {res['plain_ms']:.3f} ms "
                  f"{res['plain_gbs']:.1f} GB/s; {launches} launches")
    for rows, dtype in (((1 << 20) - 37, torch.bfloat16), (1 << 18, torch.float32)):
        table, idx = bench_gather.make_inputs(GATHER_TABLE_ROWS, rows, GATHER_C, dtype, device,
                                              SEED + 1)
        bench_gather.check(table, idx, 512)
        log("gather", f"{rows} rows {str(dtype)[6:]}: bit-identical to index_select")
        del table, idx
    # rows read from the table and written out once, the indices read once
    rows = 1 << 20
    bound = bound_ms(2 * rows * GATHER_C * 2 + rows * 4)
    log("gather", f"bound {bound:.4f} ms: kernel at {100 * bound / res['ms']:.1f}% of it, "
                  f"index_select at {100 * bound / res['plain_ms']:.1f}%")
    return {"launches": launches, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": bound, "bound_by": "bytes",
            "library_ms": res["plain_ms"]}


class _LogRecords(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_cli(smi: str) -> dict:
    """The stage-1 CLI on a synthetic VOC tree: train, resume, eval-only.
    Returns the kernel launches of its training steps and evals."""
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import write_synthetic_voc
    from sos_wsod_torch.kernels import roi_pool as fwd, roi_pool_bwd as bwd
    from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN
    from sos_wsod_torch.tools import train_net_stage1 as cli

    cli_trainer = cli.Stage1Trainer

    class ProbeTrainer(cli_trainer):
        """The CLI's trainer, timing each step on the card and recording
        its image ids and kernel launches."""
        runs = []

        def __init__(self, cfg, model, data_iter):
            self.step_ms, self.image_ids, self.step_launches = [], [], []

            def record(stream):
                try:
                    for batch in stream:
                        self.image_ids.append([s["image_id"] for s in batch])
                        yield batch
                finally:
                    stream.close()

            super().__init__(cfg, model, record(data_iter))
            ProbeTrainer.runs.append(self)

        def run_step(self):
            torch.cuda.synchronize()
            t0, counts = time.perf_counter(), (fwd.launches, bwd.launches)
            super().run_step()
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.step_launches.append((fwd.launches - counts[0], bwd.launches - counts[1]))

    records = _LogRecords()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    logging.getLogger(cli.__name__).addHandler(records)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ids = write_synthetic_voc(tmp, CLI_SPLITS, RAW_HW, NUM_PROPOSALS, SEED)
        log("cli", f"synthetic VOC tree {dict(CLI_SPLITS)} of {RAW_HW} with {NUM_PROPOSALS} "
                   f"proposals each written in {time.perf_counter() - t0:.1f} s")
        os.chdir(tmp)
        cli.Stage1Trainer = ProbeTrainer
        try:
            def run(flags, *opts):
                args = default_argument_parser().parse_args(
                    ["--config-file", str(CONFIG), *flags, "SOLVER.IMS_PER_BATCH", "1",
                     "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2",
                     "OUTPUT_DIR", "output", *opts])
                counts = (fwd.launches, bwd.launches, _nms_launches())
                t0 = time.perf_counter()
                out = cli.main(args)
                torch.cuda.synchronize()
                return (out, time.perf_counter() - t0,
                        (fwd.launches - counts[0], bwd.launches - counts[1],
                         _nms_launches() - counts[2]))

            fwd.launches = bwd.launches = 0
            _reset_nms_launches()
            trainer, secs_a, launches_a = run([], "SOLVER.MAX_ITER", "4")
            trainer_b, secs_b, launches_b = run(["--resume"], "SOLVER.MAX_ITER", "6")
            results, secs_c, launches_c = run(["--eval-only"],
                                              "WSODEVAL.SAVE_DETECTION_RESULT", "True")
            launches = {"roi_pool_fwd": fwd.launches, "roi_pool_bwd": bwd.launches,
                        "nms": _nms_launches()}
            out = pathlib.Path("output")
            files = sorted(p.name for p in out.iterdir())
            last = (out / "last_checkpoint").read_text().strip()
            dets = json.loads((out / "detection_results" / "oicr_plus_voc_2007_test.json")
                              .read_text())
            ckpt_keys = set(torch.load(out / last, map_location="cpu", weights_only=True)["model"])
            model_keys = set(MultiInputRCNN.from_cfg(trainer.cfg, device="meta").state_dict())
        finally:
            cli.Stage1Trainer = cli_trainer
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved

    # (a) training: checkpoints, metrics, both evals' flattened scalars
    want = {"model_0000001.pth", "model_0000003.pth", "model_final.pth", "last_checkpoint",
            "metrics.json"}
    if not want <= set(files):
        raise AssertionError(f"training left {files}, missing {want - set(files)}")
    evals = {k: h.values() for k, h in trainer.storage.histories().items()
             if k.startswith("voc_2007_test/")}
    if "voc_2007_test/bbox/AP50" not in evals or any(
            [it for _, it in v] != [1, 4] or not np.isfinite([x for x, _ in v]).all()
            for v in evals.values()):
        raise AssertionError(f"eval scalars (value, iteration): {evals}")
    # (b) resume: from iteration 4 to 6, the data stream from its start
    run_a, run_b = ProbeTrainer.runs
    if (trainer_b.start_iter, trainer_b.iter, len(run_b.step_ms)) != (4, 6, 2):
        raise AssertionError(f"resume ran {trainer_b.start_iter}..{trainer_b.iter} in "
                             f"{len(run_b.step_ms)} steps")
    if run_b.image_ids[0] != run_a.image_ids[0] or "model_0000005.pth" not in files:
        raise AssertionError(f"resumed stream {run_b.image_ids} vs {run_a.image_ids}; {files}")
    # (c) eval-only: the checkpoint named by last_checkpoint, strict keys, the JSON
    loaded = [m for m in records.messages if m.startswith("Loaded the model of")]
    if len(loaded) != 1 or f"{os.sep}output{os.sep}{last} (iteration 6)" not in loaded[0]:
        raise AssertionError(f"eval-only loaded {loaded}, last_checkpoint {last}")
    if ckpt_keys != model_keys:
        raise AssertionError(f"checkpoint keys: missing {model_keys - ckpt_keys}, unexpected "
                             f"{ckpt_keys - model_keys}")
    vals = np.array([[d["score"], *d["bbox"]] for d in dets], np.float64)
    test_ids = {int(i) for i in ids["test"]}
    if not dets or not np.isfinite(vals).all() or {d["image_id"] for d in dets} != test_ids \
            or not all(1 <= d["category_id"] <= 20 for d in dets):
        raise AssertionError(f"detection JSON: {len(dets)} records, images "
                             f"{sorted({d['image_id'] for d in dets})} vs {sorted(test_ids)}")
    # (d) kernel launches: 4 + 4 per training step and 4 NMS (the mining
    # rounds), 1 forward and 1 NMS per eval image
    n_test = dict(CLI_SPLITS)["test"]
    steps = run_a.step_launches + run_b.step_launches
    expect = [(4 * 4 + 2 * n_test, 4 * 4, 4 * 4 + 2 * n_test),
              (2 * 4 + n_test, 2 * 4, 2 * 4 + n_test), (n_test, 0, n_test)]
    if steps != [(4, 4)] * 6 or [launches_a, launches_b, launches_c] != expect:
        raise AssertionError(f"kernel launches per step {steps}, per run "
                             f"{[launches_a, launches_b, launches_c]} (expected {expect})")
    ap = results["voc_2007_test"]["bbox"]["AP50"]
    log("cli", f"train 4 steps + 2 evals in {secs_a:.1f} s, step ms "
               f"{[round(t, 1) for t in run_a.step_ms]}; resume from iteration 4 (stream from "
               f"its start, images {run_b.image_ids[0]}) 2 steps + 1 eval in {secs_b:.1f} s, "
               f"step ms {[round(t, 1) for t in run_b.step_ms]}; files {files}")
    log("cli", f"eval-only loaded {last} (strict: no missing or unexpected keys) in "
               f"{secs_c:.1f} s: {len(dets)} detections, AP50 {ap:.3f}; launches ROIPool fwd/bwd "
               f"and NMS: train+evals {launches_a}, resume {launches_b}, eval-only "
               f"{launches_c} on {smi}")
    return launches


def _stage2_batch(sample, device):
    return {k: torch.as_tensor(v, device=device) for k, v in sample.items() if k != "image_id"}


def phase_stage2(device, smi: str) -> dict:
    """The stage-2 inference slice and the stage-2 CLI at full width on a
    synthetic VOC tree; returns the kernels' launches of both."""
    from sos_wsod_torch.data.build import build_stage1_test_loader
    from sos_wsod_torch.data.datasets.voc import register_all_voc
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_frcnn, load_config, write_stage2_checkpoint, write_synthetic_voc)
    from sos_wsod_torch.kernels import roi_align as align
    from sos_wsod_torch.tools import train_net_unbias as cli

    cwd = os.getcwd()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    records = _LogRecords()
    logging.getLogger(cli.__name__).addHandler(records)
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_voc(tmp, (("test", NUM_IMAGES),), RAW_HW, 8, SEED)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            cfg = load_config(str(STAGE2_CONFIG))
            model = build_synthetic_frcnn(cfg, device, SEED)
            register_all_voc()
            samples = list(build_stage1_test_loader(cfg, "voc_2007_test"))
            n_params = sum(p.numel() for p in model.parameters())
            log("stage2", f"R50-FPN Faster R-CNN {n_params / 1e6:.1f}M params "
                          f"({model.compute_dtype}), {NUM_IMAGES} images {RAW_HW} -> canvas "
                          f"{samples[0]['image'].shape[:2]} (image "
                          f"{tuple(int(x) for x in samples[0]['image_hw'])}) ready in "
                          f"{time.perf_counter() - t0:.1f} s")

            def infer():
                dets = []
                with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                    for s in samples:
                        with torch.profiler.record_function("h2d"):
                            batch = _stage2_batch(s, device)
                        dets.append(model.predict(batch)[0])
                torch.cuda.synchronize()
                return dets

            align.launches = 0
            _reset_nms_launches()
            times = []
            for _ in range(2):   # first pass cold (cuDNN plans), second warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets = infer()
                times.append(time.perf_counter() - t0)
            slice_launches = {"roi_align_fwd": align.launches, "nms": _nms_launches()}
            if slice_launches != {"roi_align_fwd": 2 * NUM_IMAGES, "nms": 4 * NUM_IMAGES}:
                raise AssertionError(f"stage-2 launches for 2 x {NUM_IMAGES} images: "
                                     f"{slice_launches} (1 ROIAlign and 2 NMS an image)")
            n_det = [int(d.valid.sum()) for d in dets]
            for d in dets:
                v = d.valid
                if not (torch.isfinite(d.boxes[v]).all() and torch.isfinite(d.scores[v]).all()):
                    raise AssertionError("non-finite stage-2 detection")
            if not any(n_det):
                raise AssertionError("no stage-2 detection on any image")
            log("stage2", f"GeneralizedRCNN.predict x {NUM_IMAGES}: detections per image "
                          f"{n_det}; launches ROIAlign {slice_launches['roi_align_fwd']}, NMS "
                          f"{slice_launches['nms']} (2 passes); smoke reading: cold "
                          f"{NUM_IMAGES / times[0]:.2f} img/s, warm {NUM_IMAGES / times[1]:.2f} "
                          f"img/s on {smi}")

            # one image through the all-plain path (plain NMS and ROIAlign)
            batch = _stage2_batch(samples[0], device)
            with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                got = model.predict(batch)
                with _plain_versions(roi_align=True):
                    want = model.predict(batch)
            pairs = [(got[0].boxes, want[0].boxes), (got[0].scores, want[0].scores),
                     (got[0].valid, want[0].valid), (got[1][0], want[1][0]),
                     (got[1][2], want[1][2]), (got[2][0], want[2][0])]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError("stage-2 predict with the kernels differs from the "
                                     "plain path")
            log("stage2", "image 0: proposals, probabilities and detections with the NMS and "
                          "ROIAlign kernels == the plain versions'")

            # 2 warm profiled images: host and device ms of each range
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            samples = samples[:2]
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                infer()
                wall_ms = (time.perf_counter() - t0) * 1e3
            host, dev, other = _range_ms(prof, STAGE2_RANGES)
            busy = sum(dev.values()) + other
            log("stage2", "ms per image over 2 profiled images, range host/device: " +
                ", ".join(f"{n} {host[n] / 2:.2f}/{dev[n] / 2:.2f}" for n in STAGE2_RANGES) +
                f", device outside the ranges {other / 2:.2f}; busy {busy / 2:.2f} of "
                f"{wall_ms / 2:.2f} ms wall ({100 * busy / wall_ms:.1f}%, profiler on); NMS "
                f"launches per rpn {_launches_per_range(prof, 'nms_sweep_kernel', 'rpn')}, per "
                f"nms_topk {_launches_per_range(prof, 'nms_sweep_kernel', 'nms_topk')}")

            # the stage-2 CLI: a checkpoint, then --eval-only at full width
            write_stage2_checkpoint("output2", cfg, SEED, iteration=12000)
            align.launches = 0
            _reset_nms_launches()
            t0 = time.perf_counter()
            results = cli.main(default_argument_parser().parse_args(
                ["--config-file", str(STAGE2_CONFIG), "--eval-only", "OUTPUT_DIR", "output2",
                 "WSODEVAL.SAVE_DETECTION_RESULT", "True"]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            cli_launches = {"roi_align_fwd": align.launches, "nms": _nms_launches()}
            cli_dets = json.loads(pathlib.Path(
                "output2/detection_results/frcnn_voc_2007_test.json").read_text())
        finally:
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved
    loaded = [m for m in records.messages if m.startswith("Loaded")]
    if cli_launches != {"roi_align_fwd": NUM_IMAGES, "nms": 2 * NUM_IMAGES} or len(loaded) != 1:
        raise AssertionError(f"stage-2 CLI: launches {cli_launches}, loaded {loaded}")
    vals = np.array([[d["score"], *d["bbox"]] for d in cli_dets], np.float64)
    ap = results["voc_2007_test"]["bbox"]["AP50"]
    if not cli_dets or not np.isfinite(vals).all() or not np.isfinite(ap):
        raise AssertionError(f"stage-2 CLI: {len(cli_dets)} detections, AP50 {ap}")
    log("stage2", f"train_net_unbias --eval-only ({loaded[0]}) in {secs:.1f} s: "
                  f"{len(cli_dets)} detections, AP50 {ap:.3f}; launches {cli_launches}")
    return {k: slice_launches[k] + cli_launches[k] for k in slice_launches}


def main() -> int:
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    fwd_times = phase_kernel_vs_plain(device)
    bwd_times = phase_backward_vs_plain(device)
    nms_times = phase_nms_vs_plain(device)
    align_times = phase_roi_align_vs_plain(device)
    infer_launches = phase_slice(device, smi)
    train_launches = phase_train(device, smi)
    gather = phase_gather(device)
    cli_launches = phase_cli(smi)
    stage2_launches = phase_stage2(device, smi)
    paths = {"stage-1 inference": infer_launches, "stage-1 training": train_launches,
             "stage-1 CLI": cli_launches, "stage-2 inference and CLI": stage2_launches}
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in ("roi_pool_fwd", "roi_pool_bwd", "nms", "roi_align_fwd")}
    log("kernels", "launches by path: " + "; ".join(
        f"{name} {p}" for name, p in paths.items()) +
        f"; gather_rows: bench_gather {gather['launches']}")
    print(json.dumps({"kernels": [
        {"name": "roi_pool_fwd", "route": "cuda", "source": "sos_wsod_torch/csrc/roi_pool_fwd.cu",
         "replaces": "sos_wsod_tpu/ops/pallas/roi_pool_fused.py:240",
         "launches": launches["roi_pool_fwd"], **fwd_times},
        {"name": "roi_pool_bwd", "route": "cuda", "source": "sos_wsod_torch/csrc/roi_pool_bwd.cu",
         "replaces": "sos_wsod_tpu/ops/pallas/roi_pool_fused.py:303",
         "launches": launches["roi_pool_bwd"], **bwd_times},
        {"name": "gather_rows", "route": "cuda", "source": "sos_wsod_torch/csrc/gather_rows.cu",
         "replaces": "tools/bench_pallas_gather.py:68", **gather},
        {"name": "nms", "route": "cuda", "source": "sos_wsod_torch/csrc/nms.cu",
         "replaces": "sos_wsod_tpu/ops/nms.py:51", "launches": launches["nms"], **nms_times},
        {"name": "roi_align_fwd", "route": "cuda", "source": "sos_wsod_torch/csrc/roi_align_fwd.cu",
         "replaces": "sos_wsod_tpu/ops/roi_align.py:52", "launches": launches["roi_align_fwd"],
         **align_times}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
