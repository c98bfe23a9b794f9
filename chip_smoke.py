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
  4d. ROIAlign backward kernel vs plain: the multi-level ROIAlign backward
     (the gradient of each level's features) against the plain backward
     run on the CPU, at the training step's shapes (512 sampled ROIs on
     p2-p5 of the 704 x 960 canvas and of the largest training canvas, 1216
     x 1664) in bf16 and f32, and on the forward's adversarial cases:
     bit-identical, and the same bits from two launches; times as called
     and on the device beside the bound, the bin-tile pairs, the plain
     backward's time on the card and index_add_'s alone for the same terms;
  4e. ROILoopPool forward vs plain: kernel E at the production shape
     (87 x 119 x 512, P = 4096 -> 3P rows [box; frame; context]) in bf16
     and f32 and at the top training map (152 x 204 x 512) in bf16 (its
     staged branch), at the production shape on a misaligned map (its
     direct branch), and on an adversarial map (a zero and a negative
     block, boxes covering the image, on its edges, below a cell, empty and
     invalid; 136 channels staged, 3 direct): torch.equal out and pos with
     and without pos and scale, the branch each case took (as the library
     reports it); its backward (kernel A bwd over the 3P rows)
     bit-identical to the plain backward run on the CPU and across two
     launches at the production shape and on the adversarial map; times as
     called and of the kernel on the device beside the bound, the plain
     version's, the window cells read and the bytes of the map read from L2
     (sos_wsod_torch/tools/bench_roi_loop_pool.py);
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
     width on the same tree; prints the detection count and AP50;
 11. stage-2 training through the CLI: sos_wsod_torch.tools.train_net_unbias
     without --eval-only, in this process, at full width (R50-FPN 256, RPN
     top-k 2000/1000, 512 sampled ROIs, fc 1024, bf16) on a synthetic VOC
     tree with the pseudo-label JSON and the dataseed of
     configs/stage23/voc_baseline.yaml; cut: SOLVER.IMG_PER_BATCH_LABEL /
     _UNLABEL 8 -> 2 and MAX_ITER 4. Checks each step's finite losses and
     its ROIAlign forward, ROIAlign backward and NMS launches (one each an
     image), the checkpoint (model, teacher) and the eval at the end; prints
     the warm step time, peak memory and, for one profiled step, the host and
     device ms of each range with the device's busy share; then
     --eval-only on the checkpoint it wrote, which must load it;
 12. stage 3 through its entry points at full width (R50-FPN 256, RPN
     2000/1000, 512 ROIs, fc 1024, FocalLoss, bf16): a synthetic VOC tree
     with pseudo labels and multi-labels and a stage-2 checkpoint from the
     seeded initializer; sos_wsod_torch.tools.splits (voc_split.yaml) in
     this process scores the train+val images with the checkpoint's student
     and writes the dataseed with half of them labeled; then
     train_net_unbias on configs/stage23/voc_ssod.yaml reading it; cut:
     SOLVER.IMG_PER_BATCH_LABEL / _UNLABEL 8 -> 2, MAX_ITER 4 (one burn-in
     step, three semi-supervised steps), SUP_PERCENT the split's. Checks the
     split's launches (one ROIAlign and one NMS an image), each step's
     finite losses and keys (num_pseudo_boxes too), the launches per step
     (burn-in 4/4/4 ROIAlign fwd/bwd, NMS; each semi-supervised step 8/6/10:
     the student's 4 + 2 images and the teacher's 2), the teacher after
     the copy step equal to the student's weights before it, the
     checkpoint's EMA teacher, --eval-only loading the teacher; then one
     more semi-supervised step on the trainer with the box predictor's
     score bias raised (+9 on a class the first unlabeled image lists, +8 on
     one it does not) so that num_pseudo_boxes > 0; prints the steps, the
     warm step time, peak memory, data_time and, for one profiled step, the
     host and device ms of each range (``ema`` and ``teacher`` among them);
 13. the pipeline through its hand-offs, then TTA, at full width on a
     synthetic VOC tree (8 train, 4 val, 4 test 375x500 JPEGs, 4000
     proposals each): a stage-1 checkpoint from the seeded initializer
     (its classes tied in each proposal, engine/synthetic.py:
     write_stage1_checkpoint, so that each image's top 100 detections hold
     its labelled classes), train_net_stage1 --eval-only with
     configs/stage1/detection_result_test.yaml (1 ROIPool and 1 NMS launch
     an image) writing the detection JSON of train, val and test; python -m
     sos_wsod_torch.tools.pgf, then add_multi_label, each in its own
     process (every train/val image with a key and a multi-label; the box
     counts before and after each filter printed); train_net_unbias on
     voc_baseline.yaml reading those labels (dataseed from
     engine/synthetic.py:write_dataseed over the images that kept a box),
     cut to 2 + 2 images and 2 steps (2/2/2 ROIAlign fwd/bwd, NMS a step,
     finite losses, the checkpoint); sos_wsod_torch.tools.train_net_test_tta
     on configs/stage23/voc07_tta_test.yaml and that checkpoint over the 4
     test images (16 views an image: 16 ROIAlign and 32 NMS launches), then
     on voc07_oicr_plus.yaml and the stage-1 checkpoint with TEST.AUG's
     defaults (18 views: AVG, 18 ROIPool and 1 NMS an image; UNION on the
     first image, 18 and 18); the detections finite and inside the image,
     AP50; the first image of each strategy against the all-plain path
     (plain ROIAlign / ROIPool and NMS), equal; warm TTA img/s, peak memory
     and, over one profiled FRCNN TTA image, host and device ms by range;
 14. data parallelism (sos_wsod_torch/engine/launch.py, parallel/comm.py,
     DistributedDataParallel in the trainers), at full width: a process
     group of one over NCCL in a spawned process, where repeat_train's 2
     stage-1 and 2 stage-2 steps run under DDP, equal to the same runs in
     this process with no group, losses and watched weights bit for bit;
     then two gloo ranks sharing the one card (NCCL refuses two ranks on one
     card), started by engine.launch.launch, running
     sos_wsod_torch/tools/check_ddp.py:run_tasks: the stage-1 CLI
     (SOLVER.IMS_PER_BATCH 2, 2 steps), a stage-1 step of 2 x 1 image with
     dropout 0 against one process's step on the same 2 images (bit for bit,
     else the largest difference and the tolerance it holds), 3 stage-1
     steps with a checkpoint after the second and a second trainer resumed
     from it, the split tool (its dataseed byte-identical to one process's),
     the stage-2 CLI (2 + 2 images, 2 steps) and the stage-3 CLI (1 burn-in
     and 2 semi-supervised steps); after every step the ranks' weights, the
     teacher's too, bit-identical; each CLI's checkpoint written by rank 0
     alone; prints each run's warm step time, seconds, peak memory and
     launches a rank, labelled as two ranks sharing one card;
 15. the single-view heads: GeneralizedRCNNWSL with each of WSDDN, OICR,
     PCL, CMIL and ContextLocNet (ROILoopPool) through the stage-1 CLI at
     full width (voc07_oicr_plus.yaml with SINGLE_VIEW_OPTS; cut:
     SOLVER.IMS_PER_BATCH 4 -> 1 and 3 steps, CMIL 2 then --resume to 3) on
     a synthetic VOC tree (4 train, 2 val, 4 test 375x500 JPEGs, 4000
     proposals each), random weights from the seed, bf16: every step's
     losses finite, the launches of kernels A fwd, A bwd, C and E a step and
     an eval image, the eval after training and --eval-only on the
     checkpoint, the first test image's detections equal to the all-plain
     path's; prints each head's losses, warm step, peak memory, and the host
     and device ms by range and the device's busy share of its profiled
     last step.
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
bytes (its operations are compares and adds). ROILoopPool's bytes: the map,
boxes, valid and scales read once, its 3P rows of out and pos written once.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import pathlib
import shutil
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
KERNELS = ("roi_pool_fwd", "roi_pool_bwd", "gather_rows", "nms", "roi_align_fwd",
           "roi_align_bwd", "roi_loop_pool_fwd")
GATHER_TABLE_ROWS, GATHER_C = 2871180, 512
CLI_SPLITS = (("train", 8), ("val", 4), ("test", 4))
RANGES = ("h2d", "backbone", "roi_pool", "box_head", "mining", "losses", "backward",
          "optimizer")
STAGE2_CONFIG = ROOT / "configs" / "stage23" / "voc_baseline.yaml"
STAGE2_RANGES = ("h2d", "backbone", "rpn", "roi_align", "box_head", "nms_topk")
ADVERSARIAL_LIMIT_S = 60       # each ROIAlign adversarial case, plain version included
# stage-2 training (phase 11): the only cut, 8 -> 2 labeled and unlabeled
# images a step and 4 steps; the splits of the synthetic tree
STAGE2_TRAIN_CUT = ["SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
                    "SOLVER.MAX_ITER", "4"]
STAGE2_TRAIN_OPTS = []          # further overrides (none on the card)
STAGE2_SPLITS = (("train", 8), ("val", 4), ("test", 2))
STAGE2_TRAIN_RANGES = ("h2d", "backbone", "rpn", "roi_align", "box_head", "losses", "backward",
                       "optimizer")
# stage-3 training (phase 12): 8 -> 2 labeled and unlabeled images a step
# and 4 steps (one burn-in, three semi-supervised); SUP_PERCENT and the
# dataseed come from the split tool
STAGE3_CONFIG = ROOT / "configs" / "stage23" / "voc_ssod.yaml"
STAGE3_TRAIN_CUT = ["SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
                    "SOLVER.MAX_ITER", "4"]
STAGE3_TRAIN_OPTS = []          # further overrides of the split and the training (none on the card)
STAGE3_TRAIN_RANGES = STAGE2_TRAIN_RANGES + ("ema", "teacher")
# the pipeline and TTA (phase 13): the stage-1 dump's config, the TTA config
# of the released detector, stage 2 on the PGF labels cut to 2 + 2 images
# and 2 steps; the overrides of each stage (none on the card)
DETECTION_CONFIG = ROOT / "configs" / "stage1" / "detection_result_test.yaml"
TTA_CONFIG = ROOT / "configs" / "stage23" / "voc07_tta_test.yaml"
PIPELINE_STAGE2_CUT = ["SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
                       "SOLVER.MAX_ITER", "2"]
PIPELINE_STAGE1_OPTS = []
PIPELINE_STAGE2_OPTS = []
# data parallelism (phase 14): a process group of one over NCCL, then two
# gloo ranks sharing the one card; the steps of each run; the overrides of
# the stage-1 and the stage-2/3 runs (none on the card) and of repeat_train's
# runs in the group of one ({} on the card: its full-width defaults)
DDP_WORLD = 2
DDP_WORLD1_BACKEND = "nccl"
DDP_REPEAT_STEPS = 2
DDP_STAGE1_OPTS = []
DDP_STAGE23_OPTS = []
DDP_REPEAT_STAGE1 = {}
DDP_REPEAT_STAGE2 = {}
# the single-view heads (phase 15): GeneralizedRCNNWSL on voc07_oicr_plus.yaml
# with the JAX defaults WSL.REFINE_NUM 3 and no box regression, each head by
# MODEL.ROI_HEADS.NAME; cut: SOLVER.IMS_PER_BATCH 4 -> 1 and 3 steps (CMIL 2,
# then --resume to 3); further overrides (none on the card)
SINGLE_VIEW_OPTS = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNNWSL", "WSL.REFINE_NUM", "3",
                    "WSL.REFINE_REG", "[False, False, False]"]
SINGLE_VIEW_HEADS = {"WSDDN": [], "OICR": [], "PCL": [], "CMIL": [],
                     "ContextLocNet": ["MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROILoopPool"]}
SINGLE_VIEW_CUT = ["SOLVER.IMS_PER_BATCH", "1", "SOLVER.CHECKPOINT_PERIOD", "100",
                   "TEST.EVAL_PERIOD", "0"]
SINGLE_VIEW_STEPS = 3
SINGLE_VIEW_SPLITS = (("train", 4), ("val", 2), ("test", 4))
SINGLE_VIEW_EXTRA = []
SINGLE_VIEW_RANGES = ("h2d", "backbone", "roi_pool", "box_head", "mining", "backward",
                      "optimizer")


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
def _plain_versions(roi_align: bool = False, roi_pool: bool = False):
    """Route the card's NMS (and, with ``roi_align`` or ``roi_pool``, its
    ROIAlign or ROIPool and ROILoopPool forwards) through the plain
    versions, for a comparison with the kernels; never on a path whose
    launches are counted."""
    from sos_wsod_torch.ops import nms as nms_ops
    from sos_wsod_torch.ops import roi_align as align_ops
    from sos_wsod_torch.ops import roi_loop_pool as loop_ops
    from sos_wsod_torch.ops import roi_pool as pool_ops

    saved = (nms_ops.nms_keep_sorted_cuda, align_ops.roi_align_fwd_cuda,
             pool_ops.roi_pool_fwd_cuda, loop_ops.roi_loop_pool_fwd_cuda)
    nms_ops.nms_keep_sorted_cuda = nms_ops.greedy_keep_sorted_reference
    if roi_align:
        def plain_align(features, boxes, valid, level, scales, **kw):
            out = align_ops.roi_align_levels_reference(features, boxes, valid, level, scales, **kw)
            return out.permute(0, 2, 3, 1)
        align_ops.roi_align_fwd_cuda = plain_align
    if roi_pool:
        def plain_pool(feat, hs, he, ws, we, valid, row_scale, return_argmax=True):
            out, pos = pool_ops.roi_pool_reference(feat, hs, he, ws, we, valid, row_scale)
            return out, (pos if return_argmax else None)
        pool_ops.roi_pool_fwd_cuda = plain_pool

        def plain_loop(feat, hs, he, ws, we, ex, valid, row_scale, return_argmax=True):
            out, pos = loop_ops.roi_loop_pool_reference(feat, hs, he, ws, we, ex, valid,
                                                        row_scale)
            return out, (pos if return_argmax else None)
        loop_ops.roi_loop_pool_fwd_cuda = plain_loop
    try:
        yield
    finally:
        (nms_ops.nms_keep_sorted_cuda, align_ops.roi_align_fwd_cuda,
         pool_ops.roi_pool_fwd_cuda, loop_ops.roi_loop_pool_fwd_cuda) = saved


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


def phase_roi_align_bwd_vs_plain(device) -> dict:
    """The ROIAlign backward kernel at the training shapes, both canvases and
    dtypes, then the adversarial cases: each bit-identical to the plain
    backward run on the CPU and across two launches, within
    ADVERSARIAL_LIMIT_S a case; times beside the bound."""
    from sos_wsod_torch.tools import bench_roi_align as bench

    res = bench.run_bwd(device, iters=20, seed=SEED)
    for name, r in res.items():
        log("kernel", f"roi_align_bwd {name} x {bench.CHANNELS}, P={bench.TRAIN_ROIS} (per level "
                      f"{r['rois_per_level']}, {r['samples']} samples, {r['terms']} terms, "
                      f"{r['tile_pairs']} bin-tile pairs): bit-identical to the plain backward "
                      f"on the CPU and across two launches; kernel {r['ms']:.4f} ms as called, "
                      f"{r['device_ms']:.4f} ms device, bound {r['bound_ms']:.4f} ms by "
                      f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of the call; bytes "
                      f"{r['bytes_bound_ms']:.4f}, operations {r['ops_bound_ms']:.4f}), plain "
                      f"{r['plain_ms']:.3f} ms, index_add_ {r['library_ms']:.3f} ms")
    for dtype in (torch.bfloat16, torch.float32):
        for name, (args, kw) in bench.bwd_adversarial_cases(device, dtype, SEED).items():
            t0 = time.perf_counter()
            bench.check_bwd(*args, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if secs > ADVERSARIAL_LIMIT_S:
                raise AssertionError(f"roi_align_bwd {name}: {secs:.1f} s, over "
                                     f"{ADVERSARIAL_LIMIT_S} s")
            log("kernel", f"roi_align_bwd {str(dtype)[6:]} {name}: bit-identical to the plain "
                          f"backward on the CPU and across two launches in {secs:.2f} s")
    r = res[f"{bench.CANVAS[0]}x{bench.CANVAS[1]} bfloat16"]
    return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def phase_loop_pool_vs_plain(device) -> dict:
    """Kernel E at the production shape in bf16 and f32 and the top training
    map in bf16 (the staged branch), at the production shape on a
    misaligned map (the direct branch), and on the adversarial map (empty
    rings, boxes on the image edge, invalid rows, zero and negative blocks;
    136 channels staged, 3 direct): torch.equal to the plain version with
    and without pos and scale, and the branch each case took; its backward
    (A bwd over the 3P rows) bit-identical to the plain backward run on the
    CPU and across two launches; times as called and on the device beside
    the bound and the plain version's
    (sos_wsod_torch/tools/bench_roi_loop_pool.py). The kernels line takes
    the production shape's bf16 case."""
    from sos_wsod_torch.tools import bench_roi_loop_pool as bench

    res = bench.run(device, iters=20, seed=SEED)
    bench.report(res, log=lambda msg: log("kernel", msg))
    want = {bench.case_name(hwc, dtype): "staged" for hwc, dtype in bench.RUN_CASES}
    want[bench.case_name(bench.FEAT_HWC, torch.bfloat16) + " misaligned"] = "direct"
    want["adversarial C=3 bfloat16"] = want["adversarial C=3 float32"] = "direct"
    for name, branch in want.items():
        if res[name]["branch"] != branch:
            raise AssertionError(f"roi_loop_pool_fwd {name}: took the {res[name]['branch']} "
                                 f"branch, expected {branch}")
    r = res["bfloat16"]
    return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "branch": r["branch"]}


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


def _align_nms_counts():
    """The launches of ROIAlign forward, ROIAlign backward and NMS so far."""
    from sos_wsod_torch.kernels import roi_align as align, roi_align_bwd as align_bwd

    return align.launches, align_bwd.launches, _nms_launches()


def _reset_align_nms_counts() -> None:
    from sos_wsod_torch.kernels import roi_align as align, roi_align_bwd as align_bwd

    align.launches = align_bwd.launches = 0
    _reset_nms_launches()


def _probe_trainer(base, counts, max_iter: int):
    """A subclass of the CLI's trainer ``base`` that times each step on the
    card, records its kernel launches (``counts()`` before and after) and
    scalars, profiles the last step and, at SEMISUPNET.BURN_UP_STEP, keeps
    the student's weights from before the step and whether the teacher
    equals them bit for bit after it."""

    class ProbeTrainer(base):
        runs = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.step_ms, self.step_launches, self.step_scalars, self.prof = [], [], [], None
            self.before_copy = self.copy_exact = None
            ProbeTrainer.runs.append(self)

        def run_step(self):
            torch.cuda.synchronize()
            copy_step = self.iter == getattr(self, "burn_up_step", None)
            if copy_step:
                self.before_copy = {k: v.clone() for k, v in self.model.state_dict().items()}
            t0, before = time.perf_counter(), counts()
            if self.iter == max_iter - 1:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as self.prof:
                    super().run_step()
                    torch.cuda.synchronize()
            else:
                super().run_step()
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            self.step_launches.append(tuple(a - b for a, b in zip(counts(), before)))
            self.step_scalars.append({k: v for k, (v, it) in self.storage.latest().items()
                                      if it == self.iter})
            if copy_step:
                teacher = self.teacher.state_dict()
                self.copy_exact = all(torch.equal(teacher[k], v)
                                      for k, v in self.before_copy.items())

    return ProbeTrainer


def phase_stage2_train(smi: str) -> dict:
    """Stage-2 training through the CLI at full width (the only cut:
    STAGE2_TRAIN_CUT), then --eval-only on its checkpoint. Returns the
    kernels' launches of the whole run."""
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import (
        load_config, write_dataseed, write_pseudo_labels, write_synthetic_voc)
    from sos_wsod_torch.tools import train_net_unbias as cli

    counts = _align_nms_counts
    cli_trainer = cli.UBTeacherTrainer
    full = load_config(str(STAGE2_CONFIG))
    cfg = load_config(str(STAGE2_CONFIG), STAGE2_TRAIN_CUT + STAGE2_TRAIN_OPTS)
    b, max_iter = cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.MAX_ITER

    ProbeTrainer = _probe_trainer(cli_trainer, counts, max_iter)
    records = _LogRecords()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    logging.getLogger(cli.__name__).addHandler(records)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_synthetic_voc(tmp, STAGE2_SPLITS, RAW_HW, 8, SEED)
        write_pseudo_labels(tmp, [split for split, _ in STAGE2_SPLITS if split != "test"])
        n_train = sum(n for split, n in STAGE2_SPLITS if split != "test")
        write_dataseed(tmp, cfg, n_train)
        log("stage2-train", f"synthetic VOC tree {dict(STAGE2_SPLITS)} of {RAW_HW} with pseudo "
                            f"labels and the dataseed ({cfg.DATALOADER.SUP_PERCENT}% of "
                            f"{n_train} labeled) in {time.perf_counter() - t0:.1f} s; cut "
                            f"{STAGE2_TRAIN_CUT} (the config's SOLVER.IMG_PER_BATCH_LABEL/_UNLABEL "
                            f"{full.SOLVER.IMG_PER_BATCH_LABEL}/"
                            f"{full.SOLVER.IMG_PER_BATCH_UNLABEL}, MAX_ITER "
                            f"{full.SOLVER.MAX_ITER}); width as configured: "
                            f"R{cfg.MODEL.RESNETS.DEPTH}-FPN {cfg.MODEL.FPN.OUT_CHANNELS}, RPN "
                            f"top-k {cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN}/"
                            f"{cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN}, "
                            f"{cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE} ROIs, fc "
                            f"{cfg.MODEL.ROI_BOX_HEAD.FC_DIM}, {cfg.TPU.COMPUTE_DTYPE}")
        os.chdir(tmp)
        cli.UBTeacherTrainer = ProbeTrainer
        try:
            def run(*flags):
                return cli.main(default_argument_parser().parse_args(
                    ["--config-file", str(STAGE2_CONFIG), *flags, *STAGE2_TRAIN_CUT,
                     *STAGE2_TRAIN_OPTS, "OUTPUT_DIR", "output3"]))

            _reset_align_nms_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = run()
            torch.cuda.synchronize()
            secs_train = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            train_launches = counts()
            t0 = time.perf_counter()
            results = run("--eval-only")
            torch.cuda.synchronize()
            secs_eval = time.perf_counter() - t0
            total = counts()
            launches = dict(zip(("roi_align_fwd", "roi_align_bwd", "nms"), total))
            state = torch.load("output3/model_final.pth", map_location="cpu", weights_only=True)
            hist = trainer.storage.histories()
        finally:
            cli.UBTeacherTrainer = cli_trainer
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved

    (probe,) = ProbeTrainer.runs
    loss_keys = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss")
    for step, sc in enumerate(probe.step_scalars):
        if not all(k in sc and np.isfinite(sc[k]) for k in loss_keys):
            raise AssertionError(f"stage-2 step {step}: losses {sc}")
    if probe.step_launches != [(b, b, b)] * max_iter:
        raise AssertionError(f"stage-2 training launches (ROIAlign fwd, bwd, NMS) per step "
                             f"{probe.step_launches}, expected {(b, b, b)} each")
    if set(state) != {"model", "teacher", "optimizer", "scheduler", "generator", "iter"} or \
            state["iter"] != max_iter:
        raise AssertionError(f"checkpoint keys {sorted(state)}, iteration {state.get('iter')}")
    if "voc_2007_test/bbox/AP50" not in hist:
        raise AssertionError(f"no eval after training: {sorted(hist)}")
    loaded = [m for m in records.messages if m.startswith("Loaded")]
    if len(loaded) != 1 or not loaded[0].endswith(f"model_final.pth (iteration {max_iter})"):
        raise AssertionError(f"eval-only loaded {loaded}")
    n_test = dict(STAGE2_SPLITS)["test"]
    eval_launches = tuple(a - c for a, c in zip(total, train_launches))
    if eval_launches != (n_test, 0, 2 * n_test):
        raise AssertionError(f"eval-only launches {eval_launches}, expected "
                             f"{(n_test, 0, 2 * n_test)}")
    for step, (ms, sc) in enumerate(zip(probe.step_ms, probe.step_scalars)):
        log("stage2-train", f"step {step}: {ms:.1f} ms" + (" (profiled)" if step == max_iter - 1
                                                            else "") + "; " +
            ", ".join(f"{k} {sc[k]:.4f}" for k in loss_keys) +
            f"; data_time {sc['data_time'] * 1e3:.1f} ms (the loader, on this thread); "
            f"launches ROIAlign fwd/bwd, NMS {probe.step_launches[step]}")
    warm = statistics.median(probe.step_ms[1:max_iter - 1])
    host, dev, other = _range_ms(probe.prof, STAGE2_TRAIN_RANGES)
    busy = sum(dev.values()) + other
    log("stage2-train", f"{max_iter} steps of {b} images + eval in {secs_train:.1f} s; smoke "
                        f"reading: warm step {warm:.1f} ms = {b * 1e3 / warm:.2f} img/s, first "
                        f"step {probe.step_ms[0]:.1f} ms; peak memory {peak_gb:.2f} GB on {smi}")
    log("stage2-train", "profiled step, range host/device ms: " +
        ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in STAGE2_TRAIN_RANGES) +
        f", device outside the ranges {other:.2f}; busy {busy:.2f} of "
        f"{probe.step_ms[-1]:.2f} ms ({100 * busy / probe.step_ms[-1]:.1f}%, profiler on)")
    log("stage2-train", f"eval-only ({loaded[0]}) in {secs_eval:.1f} s: AP50 "
                        f"{results['voc_2007_test']['bbox']['AP50']:.3f}; launches of the run "
                        f"{launches}")
    return launches


def phase_stage3_train(smi: str) -> dict:
    """Stage 3 through its entry points at full width: the split tool on a
    stage-2 checkpoint, voc_ssod through the CLI (the cuts: STAGE3_TRAIN_CUT
    and the split's dataseed), --eval-only on the teacher, then one more
    semi-supervised step on the trainer with the box predictor biased so
    that pseudo boxes pass. Returns the kernels' launches of the whole
    phase."""
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import load_config
    from sos_wsod_torch.tools import repeat_train
    from sos_wsod_torch.tools import train_net_unbias as cli

    full = load_config(str(STAGE3_CONFIG))
    cfg = load_config(str(STAGE3_CONFIG), STAGE3_TRAIN_CUT + STAGE3_TRAIN_OPTS)
    bl, bu, max_iter = (cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL,
                        cfg.SOLVER.MAX_ITER)
    burn_up = cfg.SEMISUPNET.BURN_UP_STEP
    cli_trainer = cli.UBTeacherTrainer
    ProbeTrainer = _probe_trainer(cli_trainer, _align_nms_counts, max_iter)
    records = _LogRecords()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    logging.getLogger(cli.__name__).addHandler(records)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        _reset_align_nms_counts()
        t0 = time.perf_counter()
        seed_opts = repeat_train.write_stage3_inputs(tmp, STAGE3_TRAIN_OPTS, RAW_HW, 8)
        torch.cuda.synchronize()
        secs_split = time.perf_counter() - t0
        split_launches = _align_nms_counts()
        n_train = sum(n for split, n in repeat_train.STAGE2_SPLITS if split != "test")
        seed = json.loads(pathlib.Path(tmp, seed_opts[3]).read_text())
        (percent, inner), = seed.items()
        if split_launches != (n_train, 0, n_train) or len(inner["1"]) != n_train // 2 or \
                percent != seed_opts[1]:
            raise AssertionError(f"split: launches {split_launches}, dataseed {seed}, "
                                 f"overrides {seed_opts}")
        log("stage3-train", f"synthetic VOC tree {dict(repeat_train.STAGE2_SPLITS)} of {RAW_HW} "
                            f"with pseudo labels and multi-labels, a stage-2 checkpoint, then "
                            f"sos_wsod_torch.tools.splits ({repeat_train.SPLIT_CONFIG.name}, "
                            f"--k {n_train // 2}) in {secs_split:.1f} s: percent {percent}, "
                            f"labeled positions {inner['1']}; launches ROIAlign fwd/bwd, NMS "
                            f"{split_launches}; cut {STAGE3_TRAIN_CUT} (the config's "
                            f"SOLVER.IMG_PER_BATCH_LABEL/_UNLABEL "
                            f"{full.SOLVER.IMG_PER_BATCH_LABEL}/"
                            f"{full.SOLVER.IMG_PER_BATCH_UNLABEL}, MAX_ITER "
                            f"{full.SOLVER.MAX_ITER}, SUP_PERCENT {full.DATALOADER.SUP_PERCENT}); "
                            f"width as configured: R{cfg.MODEL.RESNETS.DEPTH}-FPN "
                            f"{cfg.MODEL.FPN.OUT_CHANNELS}, RPN top-k "
                            f"{cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN}/"
                            f"{cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN}, "
                            f"{cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE} ROIs, fc "
                            f"{cfg.MODEL.ROI_BOX_HEAD.FC_DIM}, {cfg.MODEL.ROI_HEADS.LOSS}, "
                            f"{cfg.TPU.COMPUTE_DTYPE}")
        os.chdir(tmp)
        cli.UBTeacherTrainer = ProbeTrainer
        try:
            def run(*flags):
                return cli.main(default_argument_parser().parse_args(
                    ["--config-file", str(STAGE3_CONFIG), *flags, *STAGE3_TRAIN_CUT,
                     *seed_opts, *STAGE3_TRAIN_OPTS, "OUTPUT_DIR", "output5"]))

            _reset_align_nms_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = run()
            torch.cuda.synchronize()
            secs_train = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            train_launches = _align_nms_counts()
            state = torch.load("output5/model_final.pth", map_location="cpu", weights_only=True)
            ema_teacher = {k: v.to("cpu", copy=True)
                           for k, v in trainer.teacher.state_dict().items()}
            t0 = time.perf_counter()
            results = run("--eval-only")
            torch.cuda.synchronize()
            secs_eval = time.perf_counter() - t0
            eval_launches = tuple(a - c for a, c in zip(_align_nms_counts(), train_launches))
            hist = trainer.storage.histories()

            # one more semi-supervised step on the trainer, the box predictor
            # of the student and the teacher biased (tests/test_torch_ssod.py)
            # so that detections of a class the first unlabeled image lists
            # score above BBOX_THRESHOLD
            batch = next(trainer.data_iter)
            listed = np.flatnonzero(batch["unlabel_k"][0]["multi_label_oh"])
            absent = int(np.flatnonzero(batch["unlabel_k"][0]["multi_label_oh"] == 0)[0])
            with torch.no_grad():
                for m in (trainer.model, trainer.teacher):
                    bias = m.roi_heads.box_predictor.cls_score.bias
                    bias[int(listed[0])] += 9.0
                    bias[absent] += 8.0
            before = _align_nms_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            direct = {k: float(v) for k, v in trainer.semisup_step(batch).items()}
            torch.cuda.synchronize()
            direct_ms = (time.perf_counter() - t0) * 1e3
            direct_launches = tuple(a - c for a, c in zip(_align_nms_counts(), before))
            total = _align_nms_counts()
        finally:
            cli.UBTeacherTrainer = cli_trainer
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved

    (probe,) = ProbeTrainer.runs
    pseudo_keys = ("loss_cls_pseudo", "loss_box_reg_pseudo", "loss_rpn_cls_pseudo",
                   "loss_rpn_loc_pseudo", "num_pseudo_boxes")
    loss_keys = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss")
    for step, sc in enumerate(probe.step_scalars):
        keys = loss_keys + (pseudo_keys if step >= burn_up else ())
        if set(sc) != set(keys) | {"data_time"} or not all(np.isfinite(sc[k]) for k in keys):
            raise AssertionError(f"stage-3 step {step}: scalars {sc}")
    burn_in, semisup = (2 * bl, 2 * bl, 2 * bl), (2 * bl + 2 * bu, 2 * bl + bu, 2 * bl + 3 * bu)
    want = [burn_in] * burn_up + [semisup] * (max_iter - burn_up)
    if probe.step_launches != want or direct_launches != semisup:
        raise AssertionError(f"stage-3 launches (ROIAlign fwd, bwd, NMS) per step "
                             f"{probe.step_launches} and direct {direct_launches}, expected "
                             f"{want} and {semisup}")
    if not probe.copy_exact:
        raise AssertionError(f"the teacher after step {burn_up} != the student before its "
                             f"update ({probe.copy_exact})")
    if set(state) != {"model", "teacher", "optimizer", "scheduler", "generator", "iter"} or \
            state["iter"] != max_iter:
        raise AssertionError(f"checkpoint keys {sorted(state)}, iteration {state.get('iter')}")
    moved = [k for k, v in state["teacher"].items()
             if not torch.equal(v, probe.before_copy[k].cpu())]
    differ = [k for k, v in ema_teacher.items() if not torch.equal(state["teacher"][k], v)]
    if differ or not moved:
        raise AssertionError(f"the checkpoint's teacher is not the EMA teacher: {len(differ)} "
                             f"entries differ ({differ[:3]}), {len(moved)} moved since the copy")
    n_test = dict(repeat_train.STAGE2_SPLITS)["test"]
    if eval_launches != (n_test, 0, 2 * n_test):
        raise AssertionError(f"eval-only launches {eval_launches}")
    loaded = [m for m in records.messages if m.startswith("Loaded")]
    if len(loaded) != 1 or not loaded[0].startswith("Loaded the teacher of") or \
            not loaded[0].endswith(f"model_final.pth (iteration {max_iter})"):
        raise AssertionError(f"eval-only loaded {loaded}")
    if "voc_2007_test/bbox/AP50" not in hist:
        raise AssertionError(f"no eval after training: {sorted(hist)}")
    if not (all(np.isfinite(v) for v in direct.values()) and direct["num_pseudo_boxes"] > 0):
        raise AssertionError(f"direct semi-supervised step: {direct}")
    for step, (ms, sc) in enumerate(zip(probe.step_ms, probe.step_scalars)):
        log("stage3-train", f"step {step} ({'burn-in' if step < burn_up else 'semi-supervised'})"
            f": {ms:.1f} ms" + (" (profiled)" if step == max_iter - 1 else "") + "; " +
            ", ".join(f"{k} {sc[k]:.4f}" for k in loss_keys + pseudo_keys if k in sc) +
            f"; data_time {sc['data_time'] * 1e3:.1f} ms; launches ROIAlign fwd/bwd, NMS "
            f"{probe.step_launches[step]}")
    warm = statistics.median(probe.step_ms[burn_up + 1:max_iter - 1] or probe.step_ms[-1:])
    host, dev, other = _range_ms(probe.prof, STAGE3_TRAIN_RANGES)
    busy = sum(dev.values()) + other
    log("stage3-train", f"{max_iter} steps of {bl} + {bl} labeled and {bu} + {bu} unlabeled views "
                        f"+ eval in {secs_train:.1f} s; smoke reading: warm semi-supervised step "
                        f"{warm:.1f} ms = {(bl + bu) * 1e3 / warm:.2f} img/s ({bl} labeled + "
                        f"{bu} unlabeled images a step), burn-in step {probe.step_ms[0]:.1f} ms; "
                        f"peak memory {peak_gb:.2f} GB on {smi}")
    log("stage3-train", "profiled step, range host/device ms (the teacher's pass is inside "
                        "teacher; its nested backbone/rpn/roi_align/box_head host times are "
                        "counted in those rows too): " +
        ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in STAGE3_TRAIN_RANGES) +
        f", device outside the ranges {other:.2f}; busy {busy:.2f} of "
        f"{probe.step_ms[-1]:.2f} ms ({100 * busy / probe.step_ms[-1]:.1f}%, profiler on)")
    log("stage3-train", f"teacher after the copy step == the student before step {burn_up}'s "
                        f"update; checkpoint teacher == the EMA teacher ({len(moved)} of "
                        f"{len(ema_teacher)} entries moved since the copy); eval-only "
                        f"({loaded[0]}) "
                        f"in {secs_eval:.1f} s: AP50 "
                        f"{results['voc_2007_test']['bbox']['AP50']:.3f}, launches {eval_launches}")
    log("stage3-train", f"direct semi-supervised step with class {int(listed[0])} (listed) +9 "
                        f"and {absent} (absent) +8 on the score bias: {direct_ms:.1f} ms, "
                        + ", ".join(f"{k} {direct[k]:.4f}" for k in loss_keys + pseudo_keys) +
                        f"; launches {direct_launches}")
    return dict(zip(("roi_align_fwd", "roi_align_bwd", "nms"),
                    (a + b for a, b in zip(split_launches, total))))


class _ImageProbe:
    """Records, for each image the TTA CLI evaluates, the launches of A fwd,
    C and D and the synchronized wall time from its read to its
    ``process_single``, and the detections it hands the evaluator."""

    def __init__(self, cli):
        from sos_wsod_torch.kernels import roi_pool as pool
        from sos_wsod_torch.evaluation.voc_eval import PascalVOCDetectionEvaluator

        self.cli, self.evaluator_cls = cli, PascalVOCDetectionEvaluator
        self.saved = cli.read_image_bgr, PascalVOCDetectionEvaluator.process_single
        self.launches, self.ms, self.dets = [], [], {}

        def counts():
            return pool.launches, _nms_launches(), _align_nms_counts()[0]

        def read(path):
            torch.cuda.synchronize()
            self.start = time.perf_counter(), counts()
            return self.saved[0](path)

        def process_single(ev, image_id, boxes, scores, classes, valid=None):
            torch.cuda.synchronize()
            t0, c0 = self.start
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.launches.append(tuple(a - b for a, b in zip(counts(), c0)))
            self.dets[image_id] = tuple(np.asarray(x) for x in (boxes, scores, classes, valid))
            return self.saved[1](ev, image_id, boxes, scores, classes, valid)

        cli.read_image_bgr, PascalVOCDetectionEvaluator.process_single = read, process_single

    def close(self):
        self.cli.read_image_bgr, self.evaluator_cls.process_single = self.saved


def _check_tta_dets(name: str, dets: dict, sizes: dict) -> int:
    """Every image's valid detections finite and inside its image (0.01 px
    of slack for the inverse resize's rounding); returns their count."""
    n = 0
    for image_id, (boxes, scores, _, valid) in dets.items():
        h, w = sizes[image_id]
        b, sc = boxes[valid.astype(bool)], scores[valid.astype(bool)]
        lim = np.array([w, h, w, h]) + 0.01
        if not (np.isfinite(b).all() and np.isfinite(sc).all() and (b >= -0.01).all()
                and (b <= lim).all() and (b[:, 2:] >= b[:, :2]).all()):
            raise AssertionError(f"{name} image {image_id}: a detection is not finite or not "
                                 f"inside its {h}x{w} image")
        n += len(sc)
    if not n:
        raise AssertionError(f"{name}: no detection on any image")
    return n


def _same_dets(name: str, a: tuple, b: tuple) -> None:
    if not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the detections with the kernels differ from the all-plain "
                             "path's")


def phase_pipeline(smi: str) -> dict:
    """The pipeline through its hand-offs, then TTA, at full width on a
    synthetic VOC tree: the stage-1 dump (train_net_stage1 --eval-only with
    detection_result_test.yaml on a checkpoint from the seeded
    initializer), PGF and the multi-label tool (each ``python -m`` in its
    own process), stage 2 (voc_baseline) trained 2 steps on their labels,
    the FRCNN TTA (voc07_tta_test, 16 views an image) on its checkpoint and
    the WSL TTA (voc07_oicr_plus, TEST.AUG's 18 views) on the stage-1 one,
    AVG over the test images and UNION on one; each TTA strategy's first
    image against the all-plain path. Returns the launches of the path."""
    import subprocess

    from sos_wsod_torch.data.catalog import DatasetCatalog
    from sos_wsod_torch.data.datasets.voc import register_all_voc, register_pascal_voc
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import (
        load_config, write_dataseed, write_stage1_checkpoint, write_synthetic_voc)
    from sos_wsod_torch.kernels import roi_pool as pool
    from sos_wsod_torch.tools import train_net_stage1 as stage1_cli
    from sos_wsod_torch.tools import train_net_test_tta as tta_cli
    from sos_wsod_torch.tools import train_net_unbias as stage2_cli

    cfg1 = load_config(str(DETECTION_CONFIG), PIPELINE_STAGE1_OPTS)
    cfg2 = load_config(str(STAGE2_CONFIG), PIPELINE_STAGE2_CUT + PIPELINE_STAGE2_OPTS)
    tta_cfg = load_config(str(TTA_CONFIG), PIPELINE_STAGE2_OPTS)
    wsl_cfg = load_config(str(CONFIG), PIPELINE_STAGE1_OPTS)
    b, max_iter = cfg2.SOLVER.IMG_PER_BATCH_LABEL, cfg2.SOLVER.MAX_ITER
    n_frcnn_views = len(tta_cfg.TEST.AUG.MIN_SIZES) * (1 + tta_cfg.TEST.AUG.FLIP)
    n_wsl_views = len(wsl_cfg.TEST.AUG.MIN_SIZES) * (1 + wsl_cfg.TEST.AUG.FLIP)
    ProbeTrainer = _probe_trainer(stage2_cli.UBTeacherTrainer, _align_nms_counts, max_iter)
    saved_trainer = stage2_cli.UBTeacherTrainer
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    cwd = os.getcwd()

    def counts():
        return pool.launches, _nms_launches(), *_align_nms_counts()[:2]

    def delta(after, before):
        return tuple(a - c for a, c in zip(after, before))

    with tempfile.TemporaryDirectory() as tmp:
        ids = write_synthetic_voc(tmp, CLI_SPLITS, RAW_HW, NUM_PROPOSALS, SEED)
        os.chdir(tmp)
        probe = None
        try:
            write_stage1_checkpoint("output_stage1", cfg1, SEED)
            # a one-image test set (the first test image) for UNION and the
            # all-plain comparisons
            pathlib.Path("datasets/VOC2007/ImageSets/Main/tta1.txt").write_text(
                ids["test"][0] + "\n")
            register_all_voc()
            if "voc_2007_tta1" not in DatasetCatalog:
                register_pascal_voc("voc_2007_tta1", "datasets/VOC2007", "tta1", "2007")
            one = ["DATASETS.TEST", "('voc_2007_tta1',)"]
            one_props = ["DATASETS.PROPOSAL_FILES_TEST",
                         "('datasets/proposals/mcg_voc_2007_test_d2.pkl',)"]

            pool.launches = 0
            _reset_align_nms_counts()
            path = {}
            # (1) the stage-1 detection dump over train, val and test
            t0 = time.perf_counter()
            stage1_cli.main(default_argument_parser().parse_args(
                ["--config-file", str(DETECTION_CONFIG), "--eval-only", *PIPELINE_STAGE1_OPTS,
                 "OUTPUT_DIR", "output_stage1"]))
            torch.cuda.synchronize()
            secs_dump = time.perf_counter() - t0
            path["dump"] = counts()
            det_dir = pathlib.Path("datasets/VOC2007/detection_results")
            dumped = {split: json.loads((det_dir / f"oicr_plus_voc_2007_{split}.json").read_text())
                      for split, _ in CLI_SPLITS}
            n_images = sum(n for _, n in CLI_SPLITS)
            if path["dump"] != (n_images, n_images, 0, 0):
                raise AssertionError(f"stage-1 dump launches (A fwd, C, D, D bwd) "
                                     f"{path['dump']}, expected 1 A fwd and 1 C for each of "
                                     f"{n_images} images")
            for split, recs in dumped.items():
                if {r["image_id"] for r in recs} != {int(i) for i in ids[split]}:
                    raise AssertionError(f"stage-1 dump of {split}: an image without a detection")
            log("pipeline", f"stage-1 dump (train_net_stage1 --eval-only, "
                            f"{DETECTION_CONFIG.name}) of {dict(CLI_SPLITS)} images in "
                            f"{secs_dump:.1f} s: detections "
                            f"{ {k: len(v) for k, v in dumped.items()} }; launches A fwd, C "
                            f"{path['dump'][:2]} (1 and 1 an image)")

            # (2) PGF, then the multi-label tool, each in its own process
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            outs = []
            for argv in (["-m", "sos_wsod_torch.tools.pgf", "--det-path", str(det_dir),
                          "--save-path", "datasets/VOC2007/pseudo_labels",
                          "--data-root", "datasets"],
                         ["-m", "sos_wsod_torch.tools.add_multi_label"]):
                proc = subprocess.run([sys.executable, *argv], env=env, capture_output=True,
                                      text=True, timeout=120)
                if proc.returncode:
                    raise RuntimeError(f"{' '.join(argv[:2])} exited {proc.returncode}: "
                                       f"{proc.stderr[-2000:]}")
                outs.append(proc.stdout)
            n_boxes = {}
            for split in ("train", "val"):
                pgt = json.loads(pathlib.Path(
                    f"datasets/VOC2007/pseudo_labels/oicr_plus_voc_2007_{split}.json").read_text())
                keys = {str(int(i)) for i in ids[split]}
                if not keys <= set(pgt) or set(pgt.get("multi_label", {})) != keys:
                    raise AssertionError(f"pseudo labels of {split}: keys {sorted(pgt)}, "
                                         f"multi_label {sorted(pgt.get('multi_label', {}))}")
                n_boxes[split] = [len(pgt[k]) for k in sorted(keys, key=int)]
            counts_lines = [line for out in outs for line in out.splitlines() if "length" in line]
            log("pipeline", "python -m sos_wsod_torch.tools.pgf, then add_multi_label: " +
                "; ".join(counts_lines) + f"; pseudo boxes an image {n_boxes}")

            # (3) stage 2 on the PGF labels: the dataseed over the images
            # that kept a box, then 2 steps
            n_train = sum(1 for v in n_boxes.values() for n in v if n)
            write_dataseed(tmp, cfg2, n_train)
            if int(cfg2.DATALOADER.SUP_PERCENT / 100 * n_train) < 1 or \
                    int(cfg2.DATALOADER.SUP_PERCENT / 100 * n_train) == n_train:
                raise AssertionError(f"{n_train} train+val images kept a pseudo box: too few "
                                     f"for a labeled and an unlabeled set")
            stage2_cli.UBTeacherTrainer = ProbeTrainer
            t0 = time.perf_counter()
            stage2_cli.main(default_argument_parser().parse_args(
                ["--config-file", str(STAGE2_CONFIG), *PIPELINE_STAGE2_CUT,
                 *PIPELINE_STAGE2_OPTS, "OUTPUT_DIR", "output_stage2"]))
            torch.cuda.synchronize()
            secs_train = time.perf_counter() - t0
            before = counts()
            path["stage 2"] = delta(before, path["dump"])
            (run,) = ProbeTrainer.runs
            for step, sc in enumerate(run.step_scalars):
                if not all(np.isfinite(sc[k]) for k in ("loss_cls", "loss_box_reg",
                                                          "loss_rpn_cls", "loss_rpn_loc")):
                    raise AssertionError(f"stage 2 on the PGF labels, step {step}: {sc}")
            if run.step_launches != [(b, b, b)] * max_iter:
                raise AssertionError(f"stage 2 launches (D, D bwd, C) per step "
                                     f"{run.step_launches}, expected {(b, b, b)} each")
            state = torch.load("output_stage2/model_final.pth", map_location="cpu",
                               weights_only=True)
            if state["iter"] != max_iter or "model" not in state:
                raise AssertionError(f"stage-2 checkpoint: {sorted(state)} at {state.get('iter')}")
            log("pipeline", f"train_net_unbias ({STAGE2_CONFIG.name}, cut "
                            f"{PIPELINE_STAGE2_CUT}) on the PGF labels, dataseed "
                            f"engine/synthetic.write_dataseed over the {n_train} images with a "
                            f"pseudo box (splits --base-only writes another percent than the "
                            f"config's {cfg2.DATALOADER.SUP_PERCENT}): {max_iter} steps + eval in "
                            f"{secs_train:.1f} s, step ms {[round(t, 1) for t in run.step_ms]}, "
                            f"total_loss "
                            f"{[round(sc['total_loss'], 4) for sc in run.step_scalars]}; "
                            f"launches D, D bwd, C per step {run.step_launches}")

            # (4) FRCNN TTA on the stage-2 checkpoint, the 4 test images
            def tta(config, *flags):
                args = tta_cli.argument_parser().parse_args(
                    ["--config-file", str(config), *flags])
                return tta_cli.main(args)

            sizes = {d["image_id"]: (d["height"], d["width"])
                     for d in DatasetCatalog.get("voc_2007_test")}
            torch.cuda.reset_peak_memory_stats()
            probe = _ImageProbe(tta_cli)
            t0 = time.perf_counter()
            res_frcnn = tta(TTA_CONFIG, "--ckpt", os.path.abspath("output_stage2/model_final.pth"),
                            *PIPELINE_STAGE2_OPTS, "OUTPUT_DIR", "output_tta")
            secs_frcnn = time.perf_counter() - t0
            probe.close()
            frcnn = probe
            path["FRCNN TTA"] = delta(counts(), before)
            want = (0, 2 * n_frcnn_views, n_frcnn_views)
            if frcnn.launches != [want] * len(sizes):
                raise AssertionError(f"FRCNN TTA launches (A fwd, C, D) per image "
                                     f"{frcnn.launches}, expected {want}")
            n_frcnn = _check_tta_dets("FRCNN TTA", frcnn.dets, sizes)

            # (5) WSL TTA on the stage-1 checkpoint: AVG over the 4 test
            # images, UNION on the first
            before = counts()
            probe = _ImageProbe(tta_cli)
            t0 = time.perf_counter()
            res_avg = tta(CONFIG, "--ckpt", os.path.abspath("output_stage1/model_final.pth"),
                          *PIPELINE_STAGE1_OPTS, "OUTPUT_DIR", "output_wsl")
            secs_avg = time.perf_counter() - t0
            probe.close()
            avg = probe
            probe = _ImageProbe(tta_cli)
            res_union = tta(CONFIG, "--strategy", "union", "--ckpt",
                            os.path.abspath("output_stage1/model_final.pth"),
                            *PIPELINE_STAGE1_OPTS, *one, *one_props, "OUTPUT_DIR", "output_wsl")
            probe.close()
            union = probe
            path["WSL TTA"] = delta(counts(), before)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if avg.launches != [(n_wsl_views, 1, 0)] * len(sizes) or \
                    union.launches != [(n_wsl_views, n_wsl_views, 0)]:
                raise AssertionError(f"WSL TTA launches (A fwd, C, D) per image: AVG "
                                     f"{avg.launches}, UNION {union.launches}; expected "
                                     f"{(n_wsl_views, 1, 0)} and {(n_wsl_views, n_wsl_views, 0)}")
            n_avg = _check_tta_dets("WSL TTA AVG", avg.dets, sizes)
            n_union = _check_tta_dets("WSL TTA UNION", union.dets, sizes)
            launches = {k: sum(p[i] for p in path.values()) for i, k in enumerate(
                ("roi_pool_fwd", "nms", "roi_align_fwd", "roi_align_bwd"))}

            # the first test image of each strategy through the all-plain path
            first = next(iter(frcnn.dets))
            with _plain_versions(roi_align=True):
                probe = _ImageProbe(tta_cli)
                t0 = time.perf_counter()
                tta(TTA_CONFIG, "--ckpt", os.path.abspath("output_stage2/model_final.pth"),
                    *PIPELINE_STAGE2_OPTS, *one, "OUTPUT_DIR", "output_tta")
                secs_plain_frcnn = time.perf_counter() - t0
                probe.close()
            _same_dets("FRCNN TTA", frcnn.dets[first], probe.dets[first])
            with _plain_versions(roi_pool=True):
                probe = _ImageProbe(tta_cli)
                t0 = time.perf_counter()
                tta(CONFIG, "--ckpt", os.path.abspath("output_stage1/model_final.pth"),
                    *PIPELINE_STAGE1_OPTS, *one, *one_props, "OUTPUT_DIR", "output_wsl")
                secs_plain_avg = time.perf_counter() - t0
                probe.close()
            _same_dets("WSL TTA AVG", avg.dets[first], probe.dets[first])
            probe = None

            # one profiled FRCNN TTA image: host and device ms of each range
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tta(TTA_CONFIG, "--ckpt", os.path.abspath("output_stage2/model_final.pth"),
                    *PIPELINE_STAGE2_OPTS, *one, "OUTPUT_DIR", "output_tta")
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            if probe is not None:
                probe.close()
            stage2_cli.UBTeacherTrainer = saved_trainer
            os.chdir(cwd)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved

    def warm(ms):
        return 1e3 / statistics.median(ms[1:] or ms)

    log("pipeline", f"FRCNN TTA ({TTA_CONFIG.name}, {n_frcnn_views} views: "
                    f"{list(tta_cfg.TEST.AUG.MIN_SIZES)} x flip, max {tta_cfg.TEST.AUG.MAX_SIZE}) "
                    f"of {len(sizes)} test images in {secs_frcnn:.1f} s: ms an image "
                    f"{[round(t, 1) for t in frcnn.ms]}, warm {warm(frcnn.ms):.2f} img/s; "
                    f"launches A fwd, C, D an image {frcnn.launches}; {n_frcnn} detections, "
                    f"AP50 {res_frcnn['voc_2007_test']['bbox']['AP50']:.3f}")
    log("pipeline", f"WSL TTA ({CONFIG.name}, {n_wsl_views} views: "
                    f"{list(wsl_cfg.TEST.AUG.MIN_SIZES)} x flip) AVG of {len(sizes)} images in "
                    f"{secs_avg:.1f} s: ms an image {[round(t, 1) for t in avg.ms]}, warm "
                    f"{warm(avg.ms):.2f} img/s, launches {avg.launches}, {n_avg} detections, "
                    f"AP50 {res_avg['voc_2007_test']['bbox']['AP50']:.3f}; UNION of image "
                    f"{first}: {union.ms[0]:.1f} ms, launches {union.launches}, {n_union} "
                    f"detections, AP50 {res_union['voc_2007_tta1']['bbox']['AP50']:.3f}; peak "
                    f"memory of the TTA runs {peak_gb:.2f} GB on {smi}")
    log("pipeline", f"image {first}: the FRCNN TTA's detections with the kernels == the "
                    f"all-plain path's (plain NMS and ROIAlign, {secs_plain_frcnn:.1f} s), the "
                    f"WSL AVG's == the all-plain path's (plain NMS and ROIPool, "
                    f"{secs_plain_avg:.1f} s)")
    host, dev, other = _range_ms(prof, STAGE2_RANGES)
    busy = sum(dev.values()) + other
    log("pipeline", f"one profiled FRCNN TTA image ({n_frcnn_views} views), range host/device "
                    f"ms: " + ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in STAGE2_RANGES) +
        f", device outside the ranges {other:.2f}; busy {busy:.2f} of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%, profiler on)")
    log("pipeline", f"launches A fwd, C, D, D bwd by step {path}")
    return launches


def _ddp_tasks(tmp: str, seed_opts: list, n_train: int, specs: dict, numels: list,
               device: str) -> list:
    """Phase 14's tasks for the two gloo ranks (``check_ddp.run_tasks``), in
    the tree ``tmp``."""
    from sos_wsod_torch.tools import repeat_train

    stage1 = ["--config-file", str(CONFIG), "SOLVER.IMS_PER_BATCH", str(DDP_WORLD),
              "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
              *DDP_STAGE1_OPTS,
              "OUTPUT_DIR", "ddp_stage1"]
    stage2 = ["--config-file", str(STAGE2_CONFIG), *STAGE2_TRAIN_CUT, "SOLVER.MAX_ITER", "2",
              *DDP_STAGE23_OPTS, "OUTPUT_DIR", "ddp_stage2"]
    stage3 = ["--config-file", str(STAGE3_CONFIG), *STAGE3_TRAIN_CUT, "SOLVER.MAX_ITER", "3",
              *DDP_STAGE23_OPTS, *seed_opts, "OUTPUT_DIR", "ddp_stage3"]
    split = ["--config", str(repeat_train.SPLIT_CONFIG), "--ckpt", "output_stage2/model_final",
             "--save-path", "dataseed/split_world2.txt", "--k", str(n_train // 2),
             *(str(o) for o in DDP_STAGE23_OPTS)]
    return [{"name": "stage-1 CLI", "cli": "stage1", "argv": stage1},
            {"name": "stage-1 step against one process", "cli": "steps",
             "spec": specs["parity"], "out_dir": os.path.join(tmp, "parity")},
            {"name": "stage-1 checkpoint and resume", "cli": "steps",
             "spec": specs["resume"], "out_dir": os.path.join(tmp, "resume")},
            {"name": "split", "cli": "splits", "argv": split},
            {"name": "stage-2 CLI", "cli": "unbias", "argv": stage2},
            {"name": "stage-3 CLI", "cli": "unbias", "argv": stage3},
            {"name": "all-reduce", "cli": "allreduce", "numel": numels, "device": device}]


def phase_data_parallel(smi: str, device: str = "cuda") -> dict:
    """Data parallelism at full width. (1) A process group of one over NCCL
    in a spawned process: repeat_train's stage-1 and stage-2 runs there,
    under DistributedDataParallel, against the same runs in this process
    with no group, bit for bit. (2) Two gloo ranks sharing the one card
    (``engine.launch.launch(..., backend="gloo")``, one spawn for all of
    it): the stage-1 CLI (SOLVER.IMS_PER_BATCH 2, 2 steps), a stage-1 step
    of 2 x 1 image with dropout 0 against one process's step on the same 2
    images, 3 stage-1 steps with a checkpoint after the second and a resumed
    third, the split tool, the stage-2 CLI (2 + 2 images, 2 steps) and the
    stage-3 CLI (1 burn-in and 2 semi-supervised steps), the ranks' weights
    (the teacher's too) compared bit for bit after every step. Returns the
    kernels' launches of the ranks."""
    from sos_wsod_torch.engine.launch import launch, spawn
    from sos_wsod_torch.engine.synthetic import build_synthetic_model, load_config, write_dataseed
    from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN
    from sos_wsod_torch.tools import check_ddp, repeat_train

    launches = dict.fromkeys(KERNELS, 0)

    def count(report):
        for k, v in report.items():
            launches[k] += v

    with tempfile.TemporaryDirectory() as tmp:
        # (1) a group of one over NCCL
        w1 = os.path.join(tmp, "world1")
        os.makedirs(w1)
        t0 = time.perf_counter()
        spawn(check_ddp.repeat_world1, 1, args=(w1, DDP_REPEAT_STEPS, device, DDP_REPEAT_STAGE1,
                                                DDP_REPEAT_STAGE2),
              backend=DDP_WORLD1_BACKEND, device=device)
        (child,) = check_ddp.load_reports(w1, 1)
        secs_child = time.perf_counter() - t0
        count(child["launches"])
        dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
        plain = {"stage1": repeat_train.train_once(dev, DDP_REPEAT_STEPS, **DDP_REPEAT_STAGE1),
                 "stage2": repeat_train.train_stage2_once(dev, DDP_REPEAT_STEPS,
                                                          **DDP_REPEAT_STAGE2)}
        for stage in ("stage1", "stage2"):
            a, b = plain[stage], child[stage]
            keys = [k for k in a if k not in ("weights", "ddp")]
            same_w = all(torch.equal(a["weights"][n].cpu(), b["weights"][n].cpu())
                         for n in a["weights"])
            if a["ddp"] or not b["ddp"] or any(a[k] != b[k] for k in keys) or not same_w:
                raise AssertionError(f"{stage}: the group of one ({child['backend']}, DDP "
                                     f"{b['ddp']}) against no group: losses "
                                     f"{[(k, a[k], b[k]) for k in keys]}, weights same {same_w}")
        log("ddp", f"a group of one over {child['backend']} in a spawned process "
                   f"({secs_child:.1f} s): repeat_train's {DDP_REPEAT_STEPS} stage-1 and "
                   f"{DDP_REPEAT_STEPS} stage-2 steps under DistributedDataParallel equal the "
                   f"runs without a group bit for bit (losses "
                   f"{', '.join(k for k in plain['stage2'] if k not in ('weights', 'ddp'))}; "
                   f"watched weights {len(plain['stage1']['weights'])} + "
                   f"{len(plain['stage2']['weights'])}); launches {child['launches']}")

        # (2) two gloo ranks on the one card
        t0 = time.perf_counter()
        seed_opts = repeat_train.write_stage3_inputs(tmp, DDP_STAGE23_OPTS, RAW_HW, NUM_PROPOSALS)
        n_train = sum(n for split, n in repeat_train.STAGE2_SPLITS if split != "test")
        write_dataseed(tmp, load_config(str(STAGE2_CONFIG), DDP_STAGE23_OPTS), n_train)
        cfg1 = load_config(str(CONFIG), ["SOLVER.IMS_PER_BATCH", DDP_WORLD, *DDP_STAGE1_OPTS])
        model1 = build_synthetic_model(cfg1, dev, SEED)
        state = {k: v.cpu() for k, v in model1.state_dict().items()}
        # the trained weights, whose gradients DDP all-reduces: stage 1, stages 2-3
        model2 = GeneralizedRCNN.from_cfg(load_config(str(STAGE2_CONFIG), DDP_STAGE23_OPTS),
                                          device="meta")
        numels = [sum(p.numel() for p in m.parameters() if p.requires_grad)
                  for m in (model1, model2)]
        del model1, model2
        base = {"kind": "stage1", "config": str(CONFIG),
                "opts": ["SOLVER.IMS_PER_BATCH", DDP_WORLD, *DDP_STAGE1_OPTS], "model": state}
        specs = {"parity": os.path.join(tmp, "parity.pt"), "resume": os.path.join(tmp, "resume.pt")}
        synthetic = {"raw_hw": RAW_HW, "num_proposals": NUM_PROPOSALS, "seed": SEED}
        parity = dict(base, dan_dropout=0.0, synthetic=dict(synthetic, steps=1))
        torch.save(parity, specs["parity"])
        torch.save(dict(base, dan_dropout=0.5, synthetic=dict(synthetic, steps=3), resume_at=2,
                        report_model=False), specs["resume"])
        for d in ("parity", "resume", "report"):
            os.makedirs(os.path.join(tmp, d))
        tasks = _ddp_tasks(tmp, seed_opts, n_train, specs, numels, device)
        secs_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        launch(check_ddp.run_tasks, DDP_WORLD, args=(tasks, os.path.join(tmp, "report"), tmp),
               backend="gloo", device=device)
        secs_ranks = time.perf_counter() - t0
        reports = check_ddp.load_reports(os.path.join(tmp, "report"), DDP_WORLD)
        by_task = list(zip(*reports))
        split_one = pathlib.Path(tmp, "dataseed", "split.txt").read_bytes()
        split_two = pathlib.Path(tmp, "dataseed", "split_world2.txt").read_bytes()

        # one process's stage-1 step on the same 2 images, dropout 0
        batches = check_ddp.stage1_batches(load_config(str(CONFIG), parity["opts"]),
                                           **parity["synthetic"])
        one_model, one = check_ddp.build_trainer(parity, batches)
        one.train(0, len(batches))
        if device == "cuda":
            torch.cuda.synchronize()
        one_state = {k: v.cpu() for k, v in one_model.state_dict().items()}

    steps = {"stage-1 CLI": 2, "stage-1 step against one process": 1,
             "stage-1 checkpoint and resume": 3, "stage-2 CLI": 2, "stage-3 CLI": 3}
    for entries in by_task:
        name = entries[0]["name"]
        for r, e in enumerate(entries):
            count(e["launches"])
            if name in steps and ([x["iter"] for x in e["records"]] != list(range(steps[name]))
                                  or not e["ddp"]):
                raise AssertionError(f"{name}, rank {r}: steps {e.get('records')}, DDP "
                                     f"{e.get('ddp')}")
        if name in steps:
            digests = [[x["digest"] for x in e["records"]] for e in entries]
            if any(d != digests[0] for d in digests):
                raise AssertionError(f"{name}: the ranks' weights differ after a step")
        cli_saves = [e.get("saved") for e in entries]
        if name in ("stage-1 CLI", "stage-2 CLI", "stage-3 CLI") and \
                cli_saves != [["model_final.pth"]] + [[]] * (len(entries) - 1):
            raise AssertionError(f"{name}: checkpoints written {cli_saves}")
    if split_one != split_two or any(e["split"] != json.loads(split_one)
                                     for e in by_task[3]):
        raise AssertionError(f"the split of {DDP_WORLD} ranks differs from one process's: "
                             f"{split_two[:200]!r} against {split_one[:200]!r}")
    resume = by_task[2]
    if resume[0]["saved"] != ["model_0000001.pth"] or any(e["saved"] for e in resume[1:]) or \
            any(e["resumed"]["start"] != 2 or
                [x["digest"] for x in e["resumed"]["records"]] != [e["records"][2]["digest"]] or
                not torch.equal(e["resumed"]["generator"], e["generator"]) for e in resume):
        raise AssertionError(f"checkpoint and resume: saved {[e['saved'] for e in resume]}, "
                             f"resumed {[e['resumed'] for e in resume]}")
    ranks = by_task[1]
    if any(not torch.equal(ranks[0]["model"][k], e["model"][k]) for e in ranks[1:]
           for k in ranks[0]["model"]):
        raise AssertionError("stage-1 step: the ranks' weights differ")
    diff = max(float((ranks[0]["model"][k].double() - v.double()).abs().max())
               for k, v in one_state.items() if v.is_floating_point())
    if diff:
        # not bit for bit: hold each weight's change within the tests' update
        # tolerance (rtol 1e-3, atol 1e-5 x its largest change, plus an ulp)
        for k, v in one_state.items():
            if not v.is_floating_point():
                continue
            want, got = (v - state[k]).double(), (ranks[0]["model"][k] - state[k]).double()
            tol = (1e-3 * want.abs() + 1e-5 * want.abs().max()
                   + torch.from_numpy(np.spacing(state[k].abs().numpy())).double())
            if ((got - want).abs() > tol).any():
                raise AssertionError(f"stage-1 step of {DDP_WORLD} ranks against one process: "
                                     f"{k} differs by {float((got - want).abs().max())}")
    parity_line = ("bit-identical" if diff == 0.0 else
                   f"largest difference {diff:.3e}, within rtol 1e-3 / atol 1e-5 x the largest "
                   f"change + 1 ulp of each weight's change")
    log("ddp", f"{DDP_WORLD} gloo ranks on one card (their inputs {secs_inputs:.1f} s, the "
               f"ranks {secs_ranks:.1f} s, started by engine.launch.launch): the ranks' "
               f"weights (students and teachers) bit-identical after every step of every run; "
               f"each CLI's checkpoint written by rank 0 alone; the split's dataseed "
               f"byte-identical to one process's ({len(split_one)} bytes); the resumed step "
               f"equal to the straight run's on every rank, generator states too; a stage-1 "
               f"step of {DDP_WORLD} x 1 image (dropout 0) against one process's on the same "
               f"2 images: {parity_line}")
    for entries in by_task:
        name = entries[0]["name"]
        per_rank = []
        for r, e in enumerate(entries):
            ms = [x["ms"] for x in e.get("records", [])]
            warm = statistics.median(ms[1:]) if len(ms) > 1 else (ms[0] if ms else None)
            per_rank.append(f"rank {r}: " + (f"warm step {warm:.1f} ms, " if warm else "") +
                            f"{e['secs']:.1f} s, peak {e.get('peak_gb', 0):.2f} GB, launches "
                            f"{e['launches']}")
        log("ddp", f"{name} (two ranks sharing one card, not a scaling figure; a step's time "
                   f"is its run_step, the card synchronized): " + "; ".join(per_rank))
    reduce_ms = by_task[-1][0]["allreduce_ms"]
    log("ddp", "one gloo all-reduce of the trained weights' gradient (f32, through the host; "
               "two ranks on one card), median of 3: " + "; ".join(
                   f"{n:,} ({n * 4 / 1e6:.1f} MB, {name}) {reduce_ms[n]:.1f} ms"
                   for n, name in zip(numels, ("stage 1", "stages 2-3"))))
    log("ddp", f"launches of the ranks {launches} on {smi}")
    return launches


def _single_view_counts():
    """Launches of kernels A fwd, A bwd, C (both NMS kernels, once) and E."""
    from sos_wsod_torch.kernels import roi_loop_pool as loop, roi_pool as fwd, roi_pool_bwd as bwd

    return fwd.launches, bwd.launches, _nms_launches(), loop.launches


def _set_single_view_counts(counts) -> None:
    from sos_wsod_torch.kernels import nms, roi_loop_pool as loop, roi_pool as fwd
    from sos_wsod_torch.kernels import roi_pool_bwd as bwd

    fwd.launches, bwd.launches, nms.mask_launches, loop.launches = counts
    nms.sweep_launches = counts[2]


def _plain_dets_equal(name: str, cfg, output: str, device) -> int:
    """The first test image through ``predict`` of the checkpoint in
    ``output``, as the evaluation runs it (inference mode, the config's
    autocast), with the kernels and then on the all-plain path (plain pools
    and NMS): the detections must be equal. Returns the detection count."""
    from sos_wsod_torch.data.build import build_stage1_test_loader
    from sos_wsod_torch.engine.checkpoint import Checkpointer
    from sos_wsod_torch.engine.weights import load_weights
    from sos_wsod_torch.models.meta.rcnn_wsl_single import build_stage1_model

    state = Checkpointer(output).load("model_final", map_location=device)
    model = load_weights(build_stage1_model(cfg, device="meta"), state["model"], device)
    sample = next(iter(build_stage1_test_loader(cfg, cfg.DATASETS.TEST[0])))
    batch = {k: torch.as_tensor(v, device=device) for k, v in sample.items() if k != "image_id"}

    def predict():
        with torch.inference_mode(), torch.autocast(
                torch.device(device).type, dtype=torch.bfloat16,
                enabled=model.compute_dtype == torch.bfloat16):
            det = model.predict(batch)[0]
        return [t.cpu() for t in (det.boxes, det.scores, det.classes, det.valid)]

    kernel = predict()
    with _plain_versions(roi_pool=True):
        plain = predict()
    if not all(torch.equal(a, b) for a, b in zip(kernel, plain)):
        raise AssertionError(f"single-view {name}: detections with the kernels differ from the "
                             "all-plain path's")
    if not torch.isfinite(kernel[1]).all():
        raise AssertionError(f"single-view {name}: non-finite scores")
    return int(kernel[3].sum())


def phase_single_view(device, smi: str) -> dict:
    """Each single-view head (GeneralizedRCNNWSL: WSDDN, OICR, PCL, CMIL,
    ContextLocNet) through the stage-1 CLI at full width on a synthetic VOC
    tree, random weights from the seed, bf16 autocast: SINGLE_VIEW_STEPS
    steps (CMIL: 2, then --resume to 3; its loss reads the step), the eval
    after training, then --eval-only on the checkpoint; every loss finite,
    the launches of kernels A fwd, A bwd, C and E a step and an image, one
    image's detections with the kernels equal to the all-plain path's;
    prints each head's warm step, peak memory, the device's busy share and
    the host and device ms by range of its profiled last step. Returns the
    launches of the runs."""
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import load_config, write_synthetic_voc
    from sos_wsod_torch.kernels import roi_loop_pool as loop_kernel
    from sos_wsod_torch.tools import train_net_stage1 as cli

    cli_trainer = cli.Stage1Trainer
    ProbeTrainer = _probe_trainer(cli_trainer, _single_view_counts, SINGLE_VIEW_STEPS)
    n_test = dict(SINGLE_VIEW_SPLITS)["test"]
    total = dict.fromkeys(("roi_pool_fwd", "roi_pool_bwd", "nms", "roi_loop_pool_fwd"), 0)
    records = _LogRecords()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    logging.getLogger(cli.__name__).addHandler(records)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_synthetic_voc(tmp, SINGLE_VIEW_SPLITS, RAW_HW, NUM_PROPOSALS, SEED)
        log("single-view", f"synthetic VOC tree {dict(SINGLE_VIEW_SPLITS)} of {RAW_HW} with "
                           f"{NUM_PROPOSALS} proposals each in {time.perf_counter() - t0:.1f} s; "
                           f"{SINGLE_VIEW_OPTS + SINGLE_VIEW_CUT}")
        os.chdir(tmp)
        cli.Stage1Trainer = ProbeTrainer
        try:
            for head, head_opts in SINGLE_VIEW_HEADS.items():
                opts = [*SINGLE_VIEW_OPTS, "MODEL.ROI_HEADS.NAME", f"{head}ROIHeads", *head_opts,
                        *SINGLE_VIEW_CUT, *SINGLE_VIEW_EXTRA, "OUTPUT_DIR", f"out_{head}"]
                cfg = load_config(str(CONFIG), opts)

                def run(*flags, steps=SINGLE_VIEW_STEPS):
                    return cli.main(default_argument_parser().parse_args(
                        ["--config-file", str(CONFIG), *flags, *opts, "SOLVER.MAX_ITER",
                         str(steps)]))

                ProbeTrainer.runs.clear()
                _set_single_view_counts((0, 0, 0, 0))
                loop_kernel.branch_launches.update(staged=0, direct=0)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if head == "CMIL":
                    run(steps=SINGLE_VIEW_STEPS - 1)
                    trainer = run("--resume")
                else:
                    trainer = run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                trained = _single_view_counts()
                results = run("--eval-only")
                torch.cuda.synchronize()
                launches = _single_view_counts()
                branches = dict(loop_kernel.branch_launches)
                n_dets = _plain_dets_equal(head, cfg, f"out_{head}", device)
                _set_single_view_counts(launches)   # the comparison's launches do not count
                for k, v in zip(total, launches):
                    total[k] += v

                probes = ProbeTrainer.runs
                steps = [ms for pr in probes for ms in pr.step_ms]
                step_launches = [lc for pr in probes for lc in pr.step_launches]
                scalars = [sc for pr in probes for sc in pr.step_scalars]
                loop_head = head == "ContextLocNet"
                per_step = (0, 1, 0, 1) if loop_head else (1, 1, 0, 0)
                per_image = (0, 0, 1, 1) if loop_head else (1, 0, 1, 0)
                if step_launches != [per_step] * SINGLE_VIEW_STEPS:
                    raise AssertionError(f"single-view {head}: launches (A fwd, A bwd, C, E) "
                                         f"per step {step_launches}, expected {per_step}")
                evals = 2 if head == "CMIL" else 1     # the evals after training
                want_train = tuple(SINGLE_VIEW_STEPS * a + evals * n_test * b
                                   for a, b in zip(per_step, per_image))
                want_eval = tuple(n_test * b for b in per_image)
                got_eval = tuple(a - b for a, b in zip(launches, trained))
                if (trained, got_eval) != (want_train, want_eval):
                    raise AssertionError(f"single-view {head}: launches (A fwd, A bwd, C, E) of "
                                         f"the training runs {trained}, of --eval-only "
                                         f"{got_eval}; expected {want_train}, {want_eval}")
                for step, sc in enumerate(scalars):
                    losses = {k: v for k, v in sc.items() if k.startswith("loss")}
                    if "loss_cls" not in losses or not np.isfinite(
                            list(losses.values()) + [sc["total_loss"]]).all():
                        raise AssertionError(f"single-view {head} step {step}: {sc}")
                ran = [(pr.start_iter, pr.iter) for pr in probes]
                if head == "CMIL" and ran != [(0, 2), (2, 3)]:
                    raise AssertionError(f"CMIL: the runs went from and to {ran}")
                ap = results["voc_2007_test"]["bbox"]["AP50"]
                if not np.isfinite(ap):
                    raise AssertionError(f"single-view {head}: AP50 {ap}")
                warm = statistics.median(steps[1:-1])
                host, dev, other = _range_ms(probes[-1].prof, SINGLE_VIEW_RANGES)
                busy = sum(dev.values()) + other
                log("single-view", f"{head}: {len(steps)} steps in {secs:.1f} s with the evals"
                    + (" (2, then --resume from its checkpoint to 3)" if head == "CMIL" else "")
                    + "; losses " + "; ".join(
                        ", ".join(f"{k} {v:.4f}" for k, v in sc.items() if k.startswith("loss"))
                        for sc in scalars)
                    + f"; step ms {[round(t, 1) for t in steps]}, warm {warm:.1f} ms = "
                    f"{1e3 / warm:.2f} img/s; peak memory {peak_gb:.2f} GB; launches A fwd, "
                    f"A bwd, C, E a step {per_step}, an eval image {per_image}"
                    + (f" (E by branch {branches})" if loop_head else "")
                    + f"; eval-only AP50 {ap:.3f}; first test image's {n_dets} detections "
                    f"equal to the all-plain path's on {smi}")
                log("single-view", f"{head} profiled step, range host/device ms: " +
                    ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in SINGLE_VIEW_RANGES) +
                    f", device outside the ranges {other:.2f}; busy {busy:.2f} of "
                    f"{steps[-1]:.2f} ms ({100 * busy / steps[-1]:.1f}%, profiler on)")
                shutil.rmtree(f"out_{head}")
        finally:
            cli.Stage1Trainer = cli_trainer
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved
    return total


def timed(name: str, fn, *args):
    """``fn(*args)``, logging its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log("time", f"{name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    smi = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timed("2 build", phase_build)
    fwd_times = timed("3 ROIPool forward", phase_kernel_vs_plain, device)
    bwd_times = timed("4 ROIPool backward", phase_backward_vs_plain, device)
    nms_times = timed("4b NMS", phase_nms_vs_plain, device)
    align_times = timed("4c ROIAlign forward", phase_roi_align_vs_plain, device)
    align_bwd_times = timed("4d ROIAlign backward", phase_roi_align_bwd_vs_plain, device)
    loop_times = timed("4e ROILoopPool forward", phase_loop_pool_vs_plain, device)
    infer_launches = timed("5 stage-1 inference", phase_slice, device, smi)
    train_launches = timed("6 stage-1 training", phase_train, device, smi)
    gather = timed("7 gather", phase_gather, device)
    cli_launches = timed("8 stage-1 CLI", phase_cli, smi)
    stage2_launches = timed("9-10 stage-2 inference and CLI", phase_stage2, device, smi)
    stage2_train_launches = timed("11 stage-2 training", phase_stage2_train, smi)
    stage3_train_launches = timed("12 stage-3 split and training", phase_stage3_train, smi)
    pipeline_launches = timed("13 pipeline and TTA", phase_pipeline, smi)
    ddp_launches = timed("14 data parallel", phase_data_parallel, smi)
    single_launches = timed("15 single-view heads", phase_single_view, device, smi)
    paths = {"stage-1 inference": infer_launches, "stage-1 training": train_launches,
             "stage-1 CLI": cli_launches, "stage-2 inference and CLI": stage2_launches,
             "stage-2 training": stage2_train_launches,
             "stage-3 split and training": stage3_train_launches,
             "pipeline and TTA": pipeline_launches, "data parallel": ddp_launches,
             "single-view heads": single_launches}
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in ("roi_pool_fwd", "roi_pool_bwd", "nms", "roi_align_fwd",
                          "roi_align_bwd", "roi_loop_pool_fwd")}
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
         **align_times},
        {"name": "roi_align_bwd", "route": "cuda", "source": "sos_wsod_torch/csrc/roi_align_bwd.cu",
         "replaces": "sos_wsod_tpu/ops/roi_align.py:52 (autodiff)",
         "launches": launches["roi_align_bwd"], **align_bwd_times},
        {"name": "roi_loop_pool_fwd", "route": "cuda",
         "source": "sos_wsod_torch/csrc/roi_loop_pool_fwd.cu",
         "replaces": "sos_wsod_tpu/ops/roi_loop_pool.py:55",
         "launches": launches["roi_loop_pool_fwd"], **loop_times}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
