#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sos_wsod_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the stage-1 and stage-2 paths with
     nvcc from the sources in this checkout (into build/sos_wsod_torch/), one
     nvcc per source, all started together, and beside them WSJDS's host
     dense CRF (native/dense_crf.cpp) with g++;
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
     x 1664) in bf16 and f32, on the forward's adversarial cases, and at
     the mask head's 14 x 14 bins (512 ROIs, 704 x 960, both dtypes):
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
     last step;
 16. the rest of the single-view family through the stage-1 CLI at full
     width, with phase 15's options, cut and tree: the CSC head (VGG16,
     ROIPool; its CPG maps before each loss), the WS-ResNet-50 backbone
     (OICR, ROIPool: kernel A at 2048 channels) and the ROIAlignV2 pooler
     (OICR on VGG16: kernels D and D bwd at one stride-8 level and 4096
     ROIs): every step's losses finite, the launches of A fwd, A bwd, C, D
     and D bwd a step and an eval image, the eval and --eval-only, the first
     test image's detections equal to the all-plain path's; each run's warm
     step, peak memory and ranges (``cpg`` and ``csc`` among them). Then one
     CSC step from its checkpoint with csc_tau 0, so that every class the
     image lists gets its CPG map: A bwd once in the ``cpg`` range for each
     of them and once in ``backward``; the CSC op on those maps on the card
     and on the CPU, W equal, and its time. Then A fwd and A bwd at
     WS-ResNet-50's res5 (88 x 120 x 2048, P = 4096) and D and D bwd (V2 and
     V1) at plain5 (87 x 119 x 512, P = 4096), each bit-identical to its
     plain version (the backwards to theirs on the CPU), timed beside the
     bound and index_add_; then one python -m
     sos_wsod_torch.tools.train_imagenet --synthetic step for vgg16 and for
     ws_resnet50 at 224 x 224, batch 32, its loss finite;
 17. the WSJDS head (VGG16, ROIPool, DAN 4096/4096, ASPP 1024/1024 x 4
     dilations) through the stage-1 CLI at full width, with phase 15's
     options, cut and tree: every step's five loss terms and total finite,
     the launches of A fwd, A bwd and C a step and an eval image, the eval
     and --eval-only, the first test image's detections equal to the
     all-plain path's, its (20, H, W) masks in [0, 1] and the instance
     masks of its detections equal too; the warm step, peak memory and the
     ranges (``cpg``, ``csc``, ``sem_seg`` among them). Then one step from
     the seeded weights with csc_tau 0 (A bwd once in ``cpg`` for each class
     the image lists; positive segmentation targets) and one with the CRF
     constraint (``from_cfg(..., wsjds_constraint=True)``, which no config
     key reaches), the host CRF at the canvas in its ``crf`` range;
 18. the UWSOD family (sos_wsod_torch/models/meta/rcnn_uwsod.py, which no
     config or CLI reaches: its ``loss`` and ``predict`` driven directly)
     at full width, random weights from the seed (engine/synthetic.py:
     build_synthetic_uwsod), bf16 autocast, one 688 x 917 image of noise on
     the 704 x 960 canvas a step: UWSODRCNN (VGG16, RPN 5 x 3 anchors on
     plain5, top-k 2000 -> 1000, DAN 4096/4096, K = 4 regressing branches,
     20 classes) and MRRPUWSODRCNN (the same over the MRRP VGG16's three
     branches). For each: predict on 2 images from the seeded weights
     (A fwd once a branch and C twice an image; finite scores, detections
     inside the image, the first image's equal to the all-plain path's),
     then 4 SGD steps with solver/build.py on the stage-1 config's solver
     (the first cold, the second with refine_mist and sampling_on: MIST's
     NMS once a branch; the last profiled): every loss finite, A fwd, A bwd
     and C a step, and the first step's pools (one a branch, the other
     branches' rows masked) against their plain versions: A fwd
     bit-identical on the card, masked rows 0, A bwd on the step's own
     gradient bit-identical to the plain backward run on the CPU; the warm
     step, peak memory, the ranges and busy share of the profiled step; then
     the MRRP stage's forward and forward + backward by conv form (cuDNN's
     dilated conv in channels_last, in NCHW, and on the d x d sub-grids);
 19. the modules no JAX entry point reaches, driven directly at full width
     (engine/synthetic.py:synthetic_mask_sample: a 688 x 917 image of noise
     on the 704 x 960 canvas, 4 gt boxes with a filled ellipse each as its
     instance mask): (a) CascadeROIHeads (3 stages, 2 x 1024 fc) and
     MaskROIHeads (4 x 256 convs, pooler 14) on the stage-2 R50-FPN and RPN
     of voc_baseline.yaml (random weights from the seed, bf16), on the
     RPN's proposals and 64 jittered copies of each gt box, so that the
     foreground quota (128 of 512) fills: two SGD steps of the cascade's
     losses plus the mask loss over a box branch's 512 samples (D fwd 5, D
     bwd 4, C once a step), then predict_scores_boxes and the top 100
     detections' masks (D fwd 4, C once); the first step's losses, the
     gradients of p2-p5 and of both heads' parameters, and the predictions
     equal the all-plain path's bit for bit (its ROIAlign backward run on
     the CPU; cuDNN deterministic for the gradients); (b)
     DeformBottleneckBlock v1 and v2 at WS-ResNet-50's res5 (2048 -> 512 ->
     2048, dilation 2, 88 x 120, f32, offsets of a few pixels, FrozenBN
     statistics near the identity): forward and every gradient on the card
     within the CPU test's tolerance of the CPU's, which samples at the
     card's offsets and whose ReLUs take the card's side of 0 where the two
     lie within 1e-5 of the largest input on either side (counted); times and
     peak memory; deform_conv2d at zero offsets against cuDNN's conv, within
     1e-4, both timed; (c) roi_label at 4096 ROIs x 20 classes on the card
     equal to the CPU with one permutation; (d) the rotated IoU at 1000 x
     1000 within 1e-5 of the CPU (and how many pairs are not bit-identical),
     and rotated NMS at 2000 boxes through
     kernel C's sweep alone, keeping what the plain fixpoint keeps over the
     same IoU matrix; (e) LossEvalHook over 2 validation batches of 2 images
     of the stage-2 detector: its val_total_loss_student equal to the mean
     of the model's own "val_loss" totals (D fwd and C once an image);
 20. the entry points, tensor parallelism and the weight readers: (a)
     sos_wsod_torch.entry.entry() on the card (the flagship OICR+ forward at
     the JAX entry's sizes, f32): its shapes, A fwd and C once, every output
     equal to the all-plain path's, its warm time; (b) tensor parallelism of
     the DAN fc stack at full width (voc07_oicr_plus.yaml: VGG16, DAN 25088
     -> 4096 -> 4096, K = 4, P = 4096, bf16; cut: SOLVER.IMS_PER_BATCH 4 ->
     1): two gloo ranks sharing the card as dp1 x tp2
     (sos_wsod_torch/parallel/tensor.py), 3 steps from the seeded weights,
     the first against one process's step on the same weights, batch and
     seed (total_loss and loss_cls within 1%, the gathered fc1 and fc2
     after the update within rtol 1e-2 / atol 1e-5, the same A fwd, A bwd
     and C launches a rank as one process), the second's time, the third's
     all-reduces each timed alone (bytes, ms), peak memory a rank; the
     ranks' checkpoint, in the one-process layout, loads into one process's
     trainer; (c) sos_wsod_torch.entry.dryrun_multichip(4) on the card, 4
     gloo ranks sharing it; (d) the weight readers: caffe2 R-50 blobs
     (pickled, from the seed) into voc_baseline's R50-FPN and d2 VGG16 blobs
     into OICR+, each followed by one predict, and a blob of another shape
     raising.
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
import torch.nn.functional as F
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
# phase 16: the CSC head, the WS-ResNet-50 backbone and the ROIAlignV2 pooler
# through the stage-1 CLI, with phase 15's options, cut and tree
SINGLE_VIEW_MORE = {
    "CSC": ["MODEL.ROI_HEADS.NAME", "CSCROIHeads"],
    "WS-ResNet-50": ["MODEL.ROI_HEADS.NAME", "OICRROIHeads", "MODEL.BACKBONE.NAME",
                     "build_ws_resnet_backbone", "MODEL.RESNETS.DEPTH", "50"],
    "ROIAlignV2": ["MODEL.ROI_HEADS.NAME", "OICRROIHeads", "MODEL.ROI_BOX_HEAD.POOLER_TYPE",
                   "ROIAlignV2"],
}
SINGLE_VIEW_MORE_RANGES = ("h2d", "cpg", "backbone", "roi_pool", "box_head", "csc", "mining",
                           "backward", "optimizer")
WS_RESNET_HWC = (88, 120, 2048)    # res5 of WS-ResNet-50 on the 704 x 960 canvas, stride 8
ALIGN_HWC = FEAT_HWC               # the ROIAlign pooler's one level: VGG16's plain5
IMAGENET_ARGS = ["--synthetic", "--image-size", "224", "--batch-size", "32", "--max-iter", "1",
                 "--log-period", "1"]
# phase 17: the WSJDS head (VGG16, ROIPool, ASPP 1024/1024 x 4 dilations)
# through the stage-1 CLI, with phase 15's options, cut and tree
WSJDS_OPTS = ["MODEL.ROI_HEADS.NAME", "WSJDSROIHeads"]
WSJDS_KEYS = ("loss_cls_pos", "loss_cls_neg", "loss_sem_seg", "mask_loss_cls_pos",
              "mask_loss_cls_neg", "total_loss")
WSJDS_RANGES = ("h2d", "cpg", "backbone", "roi_pool", "box_head", "csc", "sem_seg", "crf",
                "backward", "optimizer")
UWSOD_MODELS = ("UWSODRCNN", "MRRPUWSODRCNN")
UWSOD_CANVAS = (704, 960)        # the padded canvas of a 688 x 917 image
UWSOD_IMAGE_HW = (688, 917)
UWSOD_KW = {}                    # the models' defaults: VOC's 20 classes, DAN 4096/4096, K = 4
UWSOD_STEPS = 3
UWSOD_PREDICT_IMAGES = 2
UWSOD_RANGES = ("backbone", "rpn", "roi_pool", "box_head", "mining", "losses", "backward",
                "optimizer")
# phase 19: the modules no JAX entry point reaches, at full width: the
# stage-2 detector's widths (overrides: none on the card), the mask head's
# 4 x 256 convs at pooler 14, 4 gt boxes in 8 slots, the top 100 detections'
# masks; the deform block at res5 (dilation 2), its offset conv's gain and
# how near 0 a ReLU's input may fall on either side on the two devices;
# roi_label's ROIs and classes; the rotated IoU's and NMS's box counts; the
# validation batches and their images
ITEM7_STAGE2_OPTS = []
ITEM7_CANVAS, ITEM7_IMAGE_HW = UWSOD_CANVAS, UWSOD_IMAGE_HW
ITEM7_GT = (4, 8)
ITEM7_JITTER = (64, 0.08)   # proposals a gt box, and their corners' spread in units of its sides
ITEM7_MASK_HEAD = {"pooler_resolution": 14, "num_conv": 4, "conv_dim": 256}
ITEM7_DETECTIONS = 100
ITEM7_DEFORM_HWC = WS_RESNET_HWC
ITEM7_OFFSET_GAIN = 4.0
ITEM7_KINK = 1e-5   # a ReLU input's two devices may straddle 0 within this of the layer's largest
ITEM7_ROI_LABEL = (4096, 20)
ITEM7_ROTATED = (1000, 2000)
ITEM7_VAL = (2, 2)
# phase 20: the tensor-parallel step's ranks (dp1 x tp2 on the one card) and
# steps (the first against one process, the second timed, the third's
# all-reduces traced); its cut: SOLVER.IMS_PER_BATCH 4 -> 1; the dryrun's
# ranks; further overrides of the tensor-parallel step and of the readers'
# models (none on the card)
TP_WORLD = 2
TP_STEPS = 3
TP_OPTS = []
DRYRUN_RANKS = 4
READER_STAGE1_OPTS = []
READER_STAGE2_OPTS = []


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

    def host(name):
        build.library_path(name, build.NATIVE_DIR / f"{name}.cpp", build.HOST_FLAGS).unlink(
            missing_ok=True)
        t0 = time.perf_counter()
        lib = build.build_host(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS) + 1) as ex:
        crf = ex.submit(host, "dense_crf")     # WSJDS's host CRF (C++, g++)
        done = list(ex.map(one, KERNELS))
        crf_lib, crf_secs = crf.result()
    for name, (lib, secs) in zip(KERNELS, done):
        report = lib.with_name(lib.name + ".log").read_text()
        ptxas = " ".join(line.split("ptxas info    : ")[-1] for line in report.splitlines()
                         if "registers" in line or "spill" in line)
        log("build", f"{name}.cu -> {lib.relative_to(ROOT)} in {secs:.2f} s; {ptxas}")
    log("build", f"dense_crf.cpp (host, g++ {' '.join(build.HOST_FLAGS)}) -> "
                 f"{crf_lib.relative_to(ROOT)} in {crf_secs:.2f} s")


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
def _plain_versions(roi_align: bool = False, roi_pool: bool = False,
                    roi_align_bwd: bool = False):
    """Route the card's NMS (and, with ``roi_align`` or ``roi_pool``, its
    ROIAlign or ROIPool and ROILoopPool forwards; with ``roi_align_bwd`` the
    ROIAlign backward, run on the CPU, where the plain backward adds in its
    fixed order) through the plain versions, for a comparison with the
    kernels; never on a path whose launches are counted."""
    from sos_wsod_torch.ops import nms as nms_ops
    from sos_wsod_torch.ops import roi_align as align_ops
    from sos_wsod_torch.ops import roi_loop_pool as loop_ops
    from sos_wsod_torch.ops import roi_pool as pool_ops

    saved = (nms_ops.nms_keep_sorted_cuda, align_ops.roi_align_fwd_cuda,
             pool_ops.roi_pool_fwd_cuda, loop_ops.roi_loop_pool_fwd_cuda,
             align_ops.roi_align_bwd_cuda)
    nms_ops.nms_keep_sorted_cuda = nms_ops.greedy_keep_sorted_reference
    if roi_align:
        def plain_align(features, boxes, valid, level, scales, **kw):
            out = align_ops.roi_align_levels_reference(features, boxes, valid, level, scales, **kw)
            return out.permute(0, 2, 3, 1)
        align_ops.roi_align_fwd_cuda = plain_align
    if roi_align_bwd:
        def plain_align_bwd(grad, shapes, boxes, valid, level, scales, **kw):
            cpu = align_ops.roi_align_levels_backward_reference(
                grad.permute(0, 3, 1, 2).cpu(), shapes, boxes.cpu(), valid.cpu(), level.cpu(),
                scales, output_size=tuple(grad.shape[1:3]), **kw)
            return [g.to(grad.device) for g in cpu]
        align_ops.roi_align_bwd_cuda = plain_align_bwd
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
         pool_ops.roi_pool_fwd_cuda, loop_ops.roi_loop_pool_fwd_cuda,
         align_ops.roi_align_bwd_cuda) = saved


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
    dtypes, then the adversarial cases and the mask head's 14 x 14 bins:
    each bit-identical to the plain backward run on the CPU and across two
    launches, within ADVERSARIAL_LIMIT_S an adversarial case; times beside
    the bound."""
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
        # the mask head's 14 x 14 bins (196 a ROI, one ROI a pass of the walk)
        t0 = time.perf_counter()
        bench.check_bwd(*bench.bwd_inputs(device, dtype, SEED, output_size=(14, 14)))
        torch.cuda.synchronize()
        log("kernel", f"roi_align_bwd {str(dtype)[6:]} {bench.TRAIN_ROIS} ROIs x 14 x 14 bins "
                      f"(the mask head's pooler) at {bench.CANVAS[0]}x{bench.CANVAS[1]}: "
                      f"bit-identical to the plain backward on the CPU and across two launches "
                      f"in {time.perf_counter() - t0:.2f} s")
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
    autocast), with the kernels and then on the all-plain path (plain pools,
    ROIAlign and NMS): the detections must be equal. Returns the detection
    count."""
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
    with _plain_versions(roi_align=True, roi_pool=True):
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


def _more_counts():
    """Launches of kernels A fwd, A bwd, C (both NMS kernels, once), D and
    D bwd."""
    from sos_wsod_torch.kernels import roi_align as align, roi_align_bwd as align_bwd
    from sos_wsod_torch.kernels import roi_pool as fwd, roi_pool_bwd as bwd

    return fwd.launches, bwd.launches, _nms_launches(), align.launches, align_bwd.launches


def _set_more_counts(counts) -> None:
    from sos_wsod_torch.kernels import nms, roi_align as align, roi_align_bwd as align_bwd
    from sos_wsod_torch.kernels import roi_pool as fwd, roi_pool_bwd as bwd

    fwd.launches, bwd.launches, nms.mask_launches, align.launches, align_bwd.launches = counts
    nms.sweep_launches = counts[2]


def _more_kernels(device, smi: str) -> None:
    """Kernels A fwd and A bwd at WS-ResNet-50's res5 (WS_RESNET_HWC, bf16,
    4000 proposals in 4096 slots), and D and D bwd at the ROIAlign pooler's
    one stride-8 level (ALIGN_HWC, bf16, the same proposals, V2 and V1): each
    bit-identical to its plain version (the backwards to theirs run on the
    CPU, and across two launches); times as called beside the bound, the
    library call's (index_add_ of the backward's terms) and, for D and D
    bwd, the device time alone."""
    from sos_wsod_torch.kernels.roi_align import roi_align_fwd_cuda
    from sos_wsod_torch.kernels.roi_align_bwd import roi_align_bwd_cuda
    from sos_wsod_torch.kernels.roi_pool import roi_pool_fwd_cuda
    from sos_wsod_torch.kernels.roi_pool_bwd import roi_pool_bwd_cuda
    from sos_wsod_torch.ops.roi_pool import bin_windows
    from sos_wsod_torch.tools import bench_roi_align as align_bench
    from sos_wsod_torch.tools.bench_roi_pool import (
        bwd_inputs, bwd_traffic_bytes, check, check_bwd, index_add_ms)
    from sos_wsod_torch.tools.measure import device_ms

    h, w, c = WS_RESNET_HWC
    feat32, boxes, valid, rs = production_pool_inputs(device, WS_RESNET_HWC, SEED)
    feat = feat32.to(torch.bfloat16)
    del feat32
    win = bin_windows(boxes, valid, h, w, 7, 7, 1.0 / 8)
    t0 = time.perf_counter()
    check({"roi_pool_fwd_cuda": lambda f, wn, v, r, p: roi_pool_fwd_cuda(
        f, *wn, v, r, return_argmax=p)}, feat, win, valid, rs)
    ms = cuda_ms(lambda: roi_pool_fwd_cuda(feat, *win, valid, rs), 10)
    bound = bound_ms(fwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, 2, True))
    log("single-view+", f"roi_pool_fwd bf16 feat {WS_RESNET_HWC} P={CAPACITY}: bit-identical "
        f"out+argmax, without pos, without scale ({time.perf_counter() - t0:.1f} s); with pos "
        f"{ms:.3f} ms (bound {bound:.4f} ms, {100 * bound / ms:.1f}% of it) on {smi}")
    del feat, win
    torch.cuda.empty_cache()
    g, pos, rs_t, win, valid = bwd_inputs(device, WS_RESNET_HWC, torch.bfloat16, SEED)
    t0 = time.perf_counter()
    check_bwd({"roi_pool_bwd_cuda": (roi_pool_bwd_cuda, True)}, g, pos, rs_t, win, valid, h, w)
    secs = time.perf_counter() - t0
    ms = cuda_ms(lambda: roi_pool_bwd_cuda(g, pos, rs_t, *win, valid, h, w), 10)
    lib_ms = index_add_ms(g, pos, rs_t, h, w, 5)
    bound = bound_ms(bwd_traffic_bytes(h, w, c, CAPACITY, 7, 7, 2))
    log("single-view+", f"roi_pool_bwd bf16 g {tuple(g.shape)} -> {WS_RESNET_HWC} f32: "
        f"bit-identical to the plain version on the CPU and across two launches ({secs:.1f} "
        f"s); kernel {ms:.3f} ms (bound {bound:.4f} ms, {100 * bound / ms:.1f}% of it), "
        f"index_add_ {lib_ms:.3f} ms on {smi}")
    del g, pos, rs_t, win
    torch.cuda.empty_cache()

    h, w, c = ALIGN_HWC
    feat32, boxes, valid, _ = production_pool_inputs(device, ALIGN_HWC, SEED)
    feats = [feat32.to(torch.bfloat16)]
    del feat32
    level = torch.zeros(CAPACITY, dtype=torch.int32, device=device)
    scales = (1.0 / 8,)
    gen = torch.Generator(device=device).manual_seed(SEED)
    grad = torch.randn((CAPACITY, 7, 7, c), generator=gen, device=device).to(torch.bfloat16)
    for aligned in (True, False):
        name = "V2" if aligned else "V1"
        args = (feats, boxes, valid, level, scales)
        t0 = time.perf_counter()
        align_bench.check(*args, aligned=aligned)
        secs = time.perf_counter() - t0
        ms = cuda_ms(lambda: roi_align_fwd_cuda(*args, aligned=aligned), 10)
        dev = device_ms(lambda: roi_align_fwd_cuda(*args, aligned=aligned), 10)
        b = align_bench.bounds(*args, aligned=aligned)
        log("single-view+", f"roi_align_fwd {name} bf16 one level {ALIGN_HWC}, P={CAPACITY} "
            f"(staged {b['staged']}, direct {b['direct']}): equal to the plain version "
            f"({secs:.1f} s); kernel {ms:.4f} ms as called, {dev:.4f} ms device, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({100 * b['bound_ms'] / ms:.1f}% of "
            f"the call; bytes {b['bytes_bound_ms']:.4f}, operations {b['ops_bound_ms']:.4f}: "
            f"{b['ops']} f32 operations) on {smi}")
        bargs = (grad, [(h, w)], boxes, valid, level, scales)
        t0 = time.perf_counter()
        align_bench.check_bwd(*bargs, aligned=aligned)
        secs = time.perf_counter() - t0
        ms = cuda_ms(lambda: roi_align_bwd_cuda(*bargs, aligned=aligned), 10)
        dev = device_ms(lambda: roi_align_bwd_cuda(*bargs, aligned=aligned), 10)
        pairs, terms = align_bench.tile_pairs(*bargs[1:], aligned=aligned)
        lib_ms = (align_bench.index_add_bwd_ms(*bargs, iters=3, aligned=aligned)
                  if aligned else float("nan"))
        torch.cuda.empty_cache()
        b = align_bench.bwd_bounds(*bargs, aligned=aligned)
        log("single-view+", f"roi_align_bwd {name} bf16 g {tuple(grad.shape)} -> one level "
            f"{ALIGN_HWC} ({b['samples']} samples, {terms} terms, {pairs} bin-tile pairs): "
            f"bit-identical to the plain backward on the CPU and across two launches "
            f"({secs:.1f} s); kernel {ms:.4f} ms as called, {dev:.4f} ms device, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({100 * b['bound_ms'] / ms:.1f}% of "
            f"the call; bytes {b['bytes_bound_ms']:.4f}, operations {b['ops_bound_ms']:.4f}), "
            f"index_add_ {lib_ms:.3f} ms on {smi}")
    del feats, grad
    torch.cuda.empty_cache()


def _profiled_step(cfg, model) -> tuple:
    """One Stage1Trainer step of ``model``, profiled, on the first batch of
    the CLI's loader whose image lists two classes or more (within 16
    batches, else its first). Returns (trainer, profile, step ms, launches
    of A fwd, A bwd, C, D, D bwd)."""
    from sos_wsod_torch.data.build import build_stage1_train_loader
    from sos_wsod_torch.engine.trainer import Stage1Trainer

    loader = build_stage1_train_loader(cfg)

    def listing_two():
        first = None
        for _ in range(16):
            batch = next(loader)
            first = first or batch
            if any(sample["gt_classes_oh"].sum() >= 2 for sample in batch):
                yield batch
                return
        yield first

    trainer = Stage1Trainer(cfg, model, listing_two())
    before = _more_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            trainer.train(0, 1)
            torch.cuda.synchronize()
    finally:
        loader.close()
    step_ms = (time.perf_counter() - t0) * 1e3
    return trainer, prof, step_ms, tuple(a - b for a, b in zip(_more_counts(), before))


def _csc_cpg_step(cfg, output: str, device, smi: str) -> tuple:
    """One more CSC step, from the checkpoint in ``output``, on a model with
    csc_tau 0 (with random weights no image score reaches the config's 0.7,
    and the CPG backward would never run), profiled (``_profiled_step``). A
    bwd must launch once in the ``cpg`` range for each class the image
    lists, and once in ``backward``. Then the CSC op on
    those CPG maps and the image's boxes on the card and on the CPU: W
    equal; and how many f32 square roots of integers torch's card gets
    otherwise than its CPU (the reason the op roots in f64). Returns the
    step's launches (A fwd, A bwd, C, D, D bwd)."""
    from sos_wsod_torch.engine.checkpoint import Checkpointer
    from sos_wsod_torch.engine.weights import load_weights
    from sos_wsod_torch.kernels import roi_pool_bwd as bwd
    from sos_wsod_torch.models.meta.rcnn_wsl_single import build_stage1_model
    from sos_wsod_torch.ops.csc import csc

    state = Checkpointer(output).load("model_final", map_location=device)
    model = load_weights(build_stage1_model(cfg, device="meta"), state["model"], device)
    model.csc_tau = 0.0
    seen = []
    compute_cpgs = model.compute_cpgs

    def probe(batch, generator=None):
        before = bwd.launches
        cpgs = compute_cpgs(batch, generator)
        seen.append((bwd.launches - before, int(batch["gt_classes_oh"].sum()), cpgs,
                     batch["boxes"], batch["prop_valid"], batch["gt_classes_oh"]))
        return cpgs

    model.compute_cpgs = probe
    trainer, prof, step_ms, launches = _profiled_step(cfg, model)
    (in_cpg, present, cpgs, boxes, valid, labels), = seen
    if in_cpg != present or launches != (2, present + 1, 0, 0, 0):
        raise AssertionError(f"CSC with csc_tau 0: A bwd {in_cpg} times in cpg for {present} "
                             f"present classes; launches (A fwd, A bwd, C, D, D bwd) {launches}")
    losses = {k: h.latest for k, h in trainer.storage.histories().items() if k.startswith("loss")}
    if not np.isfinite(list(losses.values())).all():
        raise AssertionError(f"CSC with csc_tau 0: losses {losses}")
    active = cpgs.amax(dim=(1, 2)) > 0
    if int(active.sum()) != present:
        raise AssertionError(f"CSC: {int(active.sum())} non-zero CPG maps for {present} classes")
    host, dev, other = _range_ms(prof, SINGLE_VIEW_MORE_RANGES)
    busy = sum(dev.values()) + other
    preds = torch.from_numpy(np.random.RandomState(SEED).uniform(0.3, 1.0, labels.shape[0])
                             .astype(np.float32)).to(device)
    w_card = csc(cpgs, labels, preds, boxes, valid)[0]
    w_cpu = csc(cpgs.cpu(), labels.cpu(), preds.cpu(), boxes.cpu(), valid.cpu())[0]
    if not torch.equal(w_card.cpu(), w_cpu):
        raise AssertionError(f"CSC op: W on the card differs from the CPU's in "
                             f"{int((w_card.cpu() != w_cpu).sum())} of {w_cpu.numel()}")
    csc_ms = cuda_ms(lambda: csc(cpgs, labels, preds, boxes, valid), 20)
    # why the op takes its square roots in f64: torch's f32 sqrt on the card
    areas = torch.arange(1, 2_000_001, dtype=torch.float32)
    sqrt_differ = int((areas.to(device).sqrt().cpu() != areas.sqrt()).sum())
    fg = (cpgs[active] >= 0.1).float().mean().item()
    log("single-view+", f"CSC step from its checkpoint with csc_tau 0: {present} present "
        f"classes, A bwd {in_cpg} times in cpg and once in backward, launches (A fwd, A bwd, C, "
        f"D, D bwd) {launches}; losses " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
        + f"; CPG maps {tuple(cpgs.shape)}, {100 * fg:.1f}% of the active maps' cells >= 0.1; "
        f"step {step_ms:.1f} ms (profiler on), range host/device ms: " +
        ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in SINGLE_VIEW_MORE_RANGES) +
        f" (cpg holds its own forward's ranges), device outside the ranges {other:.2f}; busy "
        f"{busy:.2f} ms ({100 * busy / step_ms:.1f}%); the CSC op on the card equal to the CPU's "
        f"(W {tuple(w_cpu.shape)}), {csc_ms:.3f} ms; torch's f32 sqrt of the integers 1 to 2e6 "
        f"on the card differs from the CPU's for {sqrt_differ} of them on {smi}")
    return launches


def phase_single_view_more(device, smi: str) -> dict:
    """GeneralizedRCNNWSL with the CSC head (VGG16, ROIPool), the WS-ResNet-50
    backbone (OICR, ROIPool: kernel A at 2048 channels) and the ROIAlignV2
    pooler (OICR on VGG16: kernels D and D bwd at one level and 4096 ROIs)
    through the stage-1 CLI at full width on phase 15's synthetic VOC tree,
    random weights from the seed, bf16: SINGLE_VIEW_STEPS steps, the eval
    after training, --eval-only on the checkpoint; every loss finite, the
    launches of A fwd, A bwd, C, D and D bwd a step and an eval image, the
    first test image's detections equal to the all-plain path's; each run's
    warm step, peak memory and host and device ms by range of its profiled
    last step. Then one CSC step with csc_tau 0 (``_csc_cpg_step``), the
    four kernels at these paths' shapes against their plain versions
    (``_more_kernels``), and one train_imagenet --synthetic run of
    IMAGENET_ARGS for each arch. Returns the launches of the paths."""
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import load_config, write_synthetic_voc
    from sos_wsod_torch.tools import train_imagenet
    from sos_wsod_torch.tools import train_net_stage1 as cli

    cli_trainer = cli.Stage1Trainer
    ProbeTrainer = _probe_trainer(cli_trainer, _more_counts, SINGLE_VIEW_STEPS)
    n_test = dict(SINGLE_VIEW_SPLITS)["test"]
    names = ("roi_pool_fwd", "roi_pool_bwd", "nms", "roi_align_fwd", "roi_align_bwd")
    total = dict.fromkeys(names, 0)
    per = {"CSC": ((2, 1, 0, 0, 0), (1, 0, 1, 0, 0)),
           "WS-ResNet-50": ((1, 1, 0, 0, 0), (1, 0, 1, 0, 0)),
           "ROIAlignV2": ((0, 0, 0, 1, 1), (0, 0, 1, 1, 0))}
    records = _LogRecords()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    logging.getLogger(cli.__name__).addHandler(records)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_voc(tmp, SINGLE_VIEW_SPLITS, RAW_HW, NUM_PROPOSALS, SEED)
        os.chdir(tmp)
        cli.Stage1Trainer = ProbeTrainer
        try:
            for name, extra in SINGLE_VIEW_MORE.items():
                opts = [*SINGLE_VIEW_OPTS, *extra, *SINGLE_VIEW_CUT, *SINGLE_VIEW_EXTRA,
                        "OUTPUT_DIR", "out", "SOLVER.MAX_ITER", str(SINGLE_VIEW_STEPS)]
                cfg = load_config(str(CONFIG), opts)

                def run(*flags):
                    return cli.main(default_argument_parser().parse_args(
                        ["--config-file", str(CONFIG), *flags, *opts]))

                ProbeTrainer.runs.clear()
                _set_more_counts((0,) * 5)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer = run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                trained = _more_counts()
                results = run("--eval-only")
                torch.cuda.synchronize()
                launches = _more_counts()
                n_dets = _plain_dets_equal(name, cfg, "out", device)
                per_step, per_image = per[name]
                probe = ProbeTrainer.runs[-1]
                if probe.step_launches != [per_step] * SINGLE_VIEW_STEPS:
                    raise AssertionError(f"{name}: launches (A fwd, A bwd, C, D, D bwd) per step "
                                         f"{probe.step_launches}, expected {per_step}")
                want_train = tuple(SINGLE_VIEW_STEPS * a + n_test * b
                                   for a, b in zip(per_step, per_image))
                got_eval = tuple(a - b for a, b in zip(launches, trained))
                if (trained, got_eval) != (want_train, tuple(n_test * b for b in per_image)):
                    raise AssertionError(f"{name}: launches (A fwd, A bwd, C, D, D bwd) of the "
                                         f"training run {trained}, of --eval-only {got_eval}")
                for step, sc in enumerate(probe.step_scalars):
                    losses = [v for k, v in sc.items() if k.startswith("loss")]
                    if not losses or not np.isfinite(losses + [sc["total_loss"]]).all():
                        raise AssertionError(f"{name} step {step}: {sc}")
                ap = results["voc_2007_test"]["bbox"]["AP50"]
                if not np.isfinite(ap):
                    raise AssertionError(f"{name}: AP50 {ap}")
                model = trainer.model
                feat_note = (f"res5 {model.backbone.out_channels} channels, fc1 "
                             f"{model.roi_heads.dan.fc1.in_features} inputs; "
                             if name.startswith("WS") else "")
                steps = probe.step_ms
                warm = statistics.median(steps[1:-1]) if len(steps) > 2 else steps[-1]
                host, dev, other = _range_ms(probe.prof, SINGLE_VIEW_MORE_RANGES)
                busy = sum(dev.values()) + other
                log("single-view+", f"{name}: {len(steps)} steps in {secs:.1f} s with the eval; "
                    f"{feat_note}losses " + "; ".join(
                        ", ".join(f"{k} {v:.4f}" for k, v in sc.items() if k.startswith("loss"))
                        for sc in probe.step_scalars)
                    + f"; step ms {[round(t, 1) for t in steps]}, warm {warm:.1f} ms = "
                    f"{1e3 / warm:.2f} img/s; peak memory {peak_gb:.2f} GB; launches (A fwd, "
                    f"A bwd, C, D, D bwd) a step {per_step}, an eval image {per_image}; "
                    f"eval-only AP50 {ap:.3f}; first test image's {n_dets} detections equal to "
                    f"the all-plain path's on {smi}")
                log("single-view+", f"{name} profiled step, range host/device ms: " +
                    ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in SINGLE_VIEW_MORE_RANGES)
                    + f", device outside the ranges {other:.2f}; busy {busy:.2f} of "
                    f"{steps[-1]:.2f} ms ({100 * busy / steps[-1]:.1f}%, profiler on)")
                if name == "CSC":
                    _set_more_counts(launches)
                    extra_step = _csc_cpg_step(cfg, "out", device, smi)
                    launches = tuple(a + b for a, b in zip(launches, extra_step))
                _set_more_counts(launches)   # the comparisons' launches do not count
                for k, v in zip(names, launches):
                    total[k] += v
                del trainer, model, probe
                ProbeTrainer.runs.clear()
                shutil.rmtree("out")
                torch.cuda.empty_cache()
        finally:
            cli.Stage1Trainer = cli_trainer
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved

    counts = _more_counts()
    _more_kernels(device, smi)
    _set_more_counts(counts)
    for arch in ("vgg16", "ws_resnet50"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_imagenet.main([*IMAGENET_ARGS, "--arch", arch])
        torch.cuda.synchronize()
        m = out["metrics"]
        if not np.isfinite(m["loss"]):
            raise AssertionError(f"train_imagenet {arch}: loss {m['loss']}")
        log("single-view+", f"train_imagenet --synthetic {arch} {IMAGENET_ARGS[1:]}: last loss "
            f"{m['loss']:.4f}, acc {m['acc']:.3f}; {out['img_per_s']:.1f} img/s over the run "
            f"(its first step), {time.perf_counter() - t0:.1f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {smi}")
        del out
        torch.cuda.empty_cache()
    return total


def _wsjds_masks(name: str, cfg, output: str, device) -> tuple:
    """The first test image through ``predict`` of the WSJDS checkpoint in
    ``output``, with the kernels and on the all-plain path: its (K, H, W)
    masks f32 in [0, 1] at the canvas, and ``crop_instance_masks`` of its
    detections, each equal between the two. Returns the masks' shape and
    the number of instance masks."""
    from sos_wsod_torch.data.build import build_stage1_test_loader
    from sos_wsod_torch.engine.checkpoint import Checkpointer
    from sos_wsod_torch.engine.weights import load_weights
    from sos_wsod_torch.models.heads.wsjds import crop_instance_masks
    from sos_wsod_torch.models.meta.rcnn_wsl_single import build_stage1_model

    state = Checkpointer(output).load("model_final", map_location=device)
    model = load_weights(build_stage1_model(cfg, device="meta"), state["model"], device)
    sample = next(iter(build_stage1_test_loader(cfg, cfg.DATASETS.TEST[0])))
    batch = {k: torch.as_tensor(v, device=device) for k, v in sample.items() if k != "image_id"}

    def predict():
        with torch.inference_mode(), torch.autocast(
                torch.device(device).type, dtype=torch.bfloat16,
                enabled=model.compute_dtype == torch.bfloat16):
            det, _, _, masks = model.predict(batch)
            inst = crop_instance_masks(masks, det.boxes[det.valid], det.classes[det.valid])
        return masks, inst

    masks, inst = predict()
    with _plain_versions(roi_align=True, roi_pool=True):
        plain_masks, plain_inst = predict()
    shape = (cfg.MODEL.ROI_HEADS.NUM_CLASSES, *batch["image"].shape[:2])
    if tuple(masks.shape) != shape or masks.dtype != torch.float32:
        raise AssertionError(f"{name}: masks {tuple(masks.shape)} {masks.dtype}, expected "
                             f"{shape} float32")
    if not (bool((masks >= 0).all()) and bool((masks <= 1).all())):
        raise AssertionError(f"{name}: masks outside [0, 1]: {masks.min()} .. {masks.max()}")
    if not (torch.equal(masks, plain_masks) and torch.equal(inst, plain_inst)):
        raise AssertionError(f"{name}: the masks or the instance masks differ from the "
                             "all-plain path's")
    return tuple(masks.shape), inst.shape[0]


def _wsjds_step(cfg, device, smi: str, *, csc_tau: float, constraint: bool) -> tuple:
    """One WSJDS step from the seeded random weights, profiled, on a model
    built by ``from_cfg(cfg, csc_tau=..., wsjds_constraint=...)`` (no config
    key reaches either) and run by Stage1Trainer directly
    (``_profiled_step``). Not from the CLI run's checkpoint: with random
    weights its 3 steps at the recipe's learning rate leave every present
    class's image score near 0.01 and the CPG maps zero. csc_tau 0: A bwd launches once in ``cpg`` for each class the image
    lists, and the segmentation targets have positives (the active maps'
    cells >= 0.1). ``constraint``: the host CRF of the masks at the canvas,
    its ``crf`` host ms. Returns the step's launches (A fwd, A bwd, C, D,
    D bwd)."""
    from sos_wsod_torch.engine.synthetic import build_synthetic_model
    from sos_wsod_torch.engine.weights import load_weights
    from sos_wsod_torch.kernels import roi_pool_bwd as bwd
    from sos_wsod_torch.models.meta.rcnn_wsl_single import GeneralizedRCNNWSL

    model = load_weights(GeneralizedRCNNWSL.from_cfg(cfg, device="meta", csc_tau=csc_tau,
                                                     wsjds_constraint=constraint),
                         build_synthetic_model(cfg, device, SEED).state_dict(), device)
    seen = []
    compute_cpgs = model.compute_cpgs

    def probe(batch, generator=None):
        before = bwd.launches
        cpgs = compute_cpgs(batch, generator)
        seen.append((bwd.launches - before, int(batch["gt_classes_oh"].sum()), cpgs))
        return cpgs

    model.compute_cpgs = probe
    trainer, prof, step_ms, launches = _profiled_step(cfg, model)
    (in_cpg, present, cpgs), = seen
    active = cpgs.amax(dim=(1, 2)) > 0
    want_cpg = present if csc_tau == 0.0 else int(active.sum())
    if in_cpg != want_cpg or launches != (2, in_cpg + 1, 0, 0, 0):
        raise AssertionError(f"WSJDS csc_tau {csc_tau}: A bwd {in_cpg} times in cpg for "
                             f"{present} present classes; launches (A fwd, A bwd, C, D, D bwd) "
                             f"{launches}")
    pos = float((cpgs[active] >= 0.1).float().mean()) if bool(active.any()) else 0.0
    if csc_tau == 0.0 and not pos > 0:
        raise AssertionError(
            f"WSJDS with csc_tau 0: no positive segmentation target; CPG maps' peaks "
            f"{cpgs.amax(dim=(1, 2)).tolist()}, {int(cpgs.isnan().sum())} NaN cells")
    hist = trainer.storage.histories()
    losses = {k: hist[k].latest for k in WSJDS_KEYS + (("loss_constraint",) if constraint
                                                       else ())}
    if not np.isfinite(list(losses.values())).all():
        raise AssertionError(f"WSJDS csc_tau {csc_tau}, constraint {constraint}: {losses}")
    host, dev, other = _range_ms(prof, WSJDS_RANGES)
    busy = sum(dev.values()) + other
    log("wsjds", f"step from the seeded weights with csc_tau {csc_tau}, constraint {constraint}: "
        f"{present} present classes, A bwd {in_cpg} times in cpg and once in backward, launches "
        f"(A fwd, A bwd, C, D, D bwd) {launches}; CPG maps {tuple(cpgs.shape)}, {100 * pos:.1f}% "
        f"of the active maps' cells >= 0.1 (positive targets); losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
        + f"; step {step_ms:.1f} ms (profiler on), range host/device ms: "
        + ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in WSJDS_RANGES)
        + f", device outside the ranges {other:.2f}; busy {busy:.2f} ms "
        f"({100 * busy / step_ms:.1f}%) on {smi}")
    return launches


def _aspp_times(device, smi: str) -> None:
    """The ASPP head at full width (512 -> 1024 -> 1024 -> 20, dilations 6
    to 24) on plain5 of the 704 x 960 canvas (88 x 120), bf16, training
    mode: forward, and forward + backward, as the port runs its dilated
    convs (on the d x d sub-grids) and as cuDNN's dilated convs in NCHW and
    in channels_last (the memory format of the model's other weights)."""
    from sos_wsod_torch.models.heads import aspp

    gen = torch.Generator(device=device).manual_seed(SEED)
    head = aspp.ASPPHead(512, 20, (1024, 1024), device=device).train()
    feat = torch.randn((88, 120, 512), generator=gen, device=device) * 10

    def run(backward):
        with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
            out = head(feat, gen)
        if backward:
            out.float().sum().backward()

    def dilated(fmt):
        def conv(c, x):
            return F.conv2d(x.contiguous(memory_format=fmt), c.weight.contiguous(memory_format=fmt),
                            c.bias, c.stride, c.padding, c.dilation)
        return conv

    sub_grids = aspp._conv_nchw
    times = {}
    try:
        for name, conv, n in (("sub-grids", sub_grids, 10),
                              ("dilated NCHW", dilated(torch.contiguous_format), 5),
                              ("dilated channels_last", dilated(torch.channels_last), 2)):
            aspp._conv_nchw = conv
            times[name] = (cuda_ms(lambda: run(False), n), cuda_ms(lambda: run(True), n))
    finally:
        aspp._conv_nchw = sub_grids
    log("wsjds", "ASPP at 88 x 120 x 512 bf16, forward / forward + backward ms: " + ", ".join(
        f"{k} {f:.2f} / {fb:.2f}" for k, (f, fb) in times.items()) + f" on {smi}")


def phase_wsjds(device, smi: str) -> dict:
    """GeneralizedRCNNWSL with the WSJDS head (VGG16, ROIPool, DAN
    4096/4096, ASPP 1024/1024 x 4 dilations, 20 classes, P = 4096 with 4000
    valid) through the stage-1 CLI at full width on phase 15's synthetic VOC
    tree, random weights from the seed, bf16: SINGLE_VIEW_STEPS steps, the
    eval after training, --eval-only on the checkpoint; every step's five
    loss terms and total finite, the launches of A fwd, A bwd and C a step
    and an eval image, the first test image's detections equal to the
    all-plain path's, and its masks and instance masks too (``_wsjds_masks``);
    the warm step, peak memory and host and device ms by range of the
    profiled last step. Then one step with csc_tau 0 and one with the CRF
    constraint, from the seeded weights (``_wsjds_step``). Returns the
    launches."""
    from sos_wsod_torch.engine.defaults import default_argument_parser
    from sos_wsod_torch.engine.synthetic import load_config, write_synthetic_voc
    from sos_wsod_torch.tools import train_net_stage1 as cli

    cli_trainer = cli.Stage1Trainer
    ProbeTrainer = _probe_trainer(cli_trainer, _more_counts, SINGLE_VIEW_STEPS)
    n_test = dict(SINGLE_VIEW_SPLITS)["test"]
    names = ("roi_pool_fwd", "roi_pool_bwd", "nms", "roi_align_fwd", "roi_align_bwd")
    per_step, per_image = (2, 1, 0, 0, 0), (1, 0, 1, 0, 0)
    records = _LogRecords()
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    logging.getLogger(cli.__name__).addHandler(records)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_voc(tmp, SINGLE_VIEW_SPLITS, RAW_HW, NUM_PROPOSALS, SEED)
        os.chdir(tmp)
        cli.Stage1Trainer = ProbeTrainer
        try:
            opts = [*SINGLE_VIEW_OPTS, *WSJDS_OPTS, *SINGLE_VIEW_CUT, *SINGLE_VIEW_EXTRA,
                    "OUTPUT_DIR", "out", "SOLVER.MAX_ITER", str(SINGLE_VIEW_STEPS)]
            cfg = load_config(str(CONFIG), opts)

            def run(*flags):
                return cli.main(default_argument_parser().parse_args(
                    ["--config-file", str(CONFIG), *flags, *opts]))

            ProbeTrainer.runs.clear()
            _set_more_counts((0,) * 5)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            trained = _more_counts()
            results = run("--eval-only")
            torch.cuda.synchronize()
            launches = _more_counts()
            n_dets = _plain_dets_equal("WSJDS", cfg, "out", device)
            mask_shape, n_inst = _wsjds_masks("WSJDS", cfg, "out", device)
            _set_more_counts(launches)   # the comparisons' launches do not count
            probe = ProbeTrainer.runs[-1]
            if probe.step_launches != [per_step] * SINGLE_VIEW_STEPS:
                raise AssertionError(f"WSJDS: launches (A fwd, A bwd, C, D, D bwd) per step "
                                     f"{probe.step_launches}, expected {per_step}")
            want_train = tuple(SINGLE_VIEW_STEPS * a + n_test * b
                               for a, b in zip(per_step, per_image))
            got_eval = tuple(a - b for a, b in zip(launches, trained))
            if (trained, got_eval) != (want_train, tuple(n_test * b for b in per_image)):
                raise AssertionError(f"WSJDS: launches (A fwd, A bwd, C, D, D bwd) of the "
                                     f"training run {trained}, of --eval-only {got_eval}")
            for step, sc in enumerate(probe.step_scalars):
                if set(WSJDS_KEYS) - set(sc) or not np.isfinite([sc[k] for k in WSJDS_KEYS]).all():
                    raise AssertionError(f"WSJDS step {step}: {sc}")
            ap = results["voc_2007_test"]["bbox"]["AP50"]
            if not np.isfinite(ap):
                raise AssertionError(f"WSJDS: AP50 {ap}")
            aspp = trainer.model.roi_heads.sem_seg_head
            conv1 = aspp.dilation6.conv1
            steps = probe.step_ms
            warm = statistics.median(steps[1:-1]) if len(steps) > 2 else steps[-1]
            host, dev, other = _range_ms(probe.prof, WSJDS_RANGES)
            busy = sum(dev.values()) + other
            log("wsjds", f"{len(steps)} steps in {secs:.1f} s with the eval; ASPP dilations "
                f"{aspp.dilations}, {conv1.in_channels} -> {conv1.out_channels} -> "
                f"{aspp.dilation6.conv2.out_channels} -> {aspp.dilation6.predictor.out_channels}"
                "; losses " + "; ".join(", ".join(f"{k} {sc[k]:.4f}" for k in WSJDS_KEYS)
                                        for sc in probe.step_scalars)
                + f"; step ms {[round(t, 1) for t in steps]}, warm {warm:.1f} ms = "
                f"{1e3 / warm:.2f} img/s; peak memory {peak_gb:.2f} GB; launches (A fwd, A bwd, "
                f"C, D, D bwd) a step {per_step}, an eval image {per_image}; eval-only AP50 "
                f"{ap:.3f}; first test image's {n_dets} detections, masks {mask_shape} and "
                f"{n_inst} instance masks equal to the all-plain path's on {smi}")
            log("wsjds", "profiled step, range host/device ms: " +
                ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in WSJDS_RANGES)
                + f", device outside the ranges {other:.2f}; busy {busy:.2f} of "
                f"{steps[-1]:.2f} ms ({100 * busy / steps[-1]:.1f}%, profiler on) on {smi}")
            del trainer, probe, aspp, conv1
            ProbeTrainer.runs.clear()
            torch.cuda.empty_cache()
            _aspp_times(device, smi)
            for csc_tau, constraint in ((0.0, False), (0.7, True)):   # 0.7: the default
                extra = _wsjds_step(cfg, device, smi, csc_tau=csc_tau, constraint=constraint)
                launches = tuple(a + b for a, b in zip(launches, extra))
                torch.cuda.empty_cache()
        finally:
            cli.Stage1Trainer = cli_trainer
            os.chdir(cwd)
            logging.getLogger(cli.__name__).removeHandler(records)
            for h in root.handlers:
                if h not in saved[0]:
                    h.close()
            root.handlers[:], root.level = saved
    _set_more_counts(launches)
    return dict(zip(names, launches))


def _uwsod_batch(seed: int, device, num_classes: int) -> dict:
    """One image as the UWSOD models take it: UWSOD_IMAGE_HW of uniform
    noise on the UWSOD_CANVAS, two classes present."""
    rng = np.random.default_rng(seed)
    h, w = UWSOD_IMAGE_HW
    image = np.zeros(UWSOD_CANVAS + (3,), np.float32)
    image[:h, :w] = rng.uniform(0, 255, (h, w, 3))
    gt = np.zeros(num_classes, np.float32)
    gt[rng.choice(num_classes, 2, replace=False)] = 1.0
    hw = torch.tensor([h, w], dtype=torch.int32, device=device)
    return {"image": torch.from_numpy(image).to(device), "valid_hw": hw, "image_hw": hw.clone(),
            "gt_classes_oh": torch.from_numpy(gt).to(device)}


class _PoolProbe:
    """Stands in for ``roi_pool`` in models/meta/rcnn_uwsod.py for one step:
    records each call's map, boxes, valid rows and row scale, and the
    gradient that reaches its output."""

    def __init__(self, pool):
        self.pool, self.calls = pool, []

    def __call__(self, feat, boxes, valid, row_scale, **kw):
        out = self.pool(feat, boxes, valid, row_scale, **kw)
        rec = {"feat": feat.detach(), "boxes": boxes, "valid": valid, "scale": row_scale,
               "spatial_scale": kw["spatial_scale"]}
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach()))
        self.calls.append(rec)
        return out


def _uwsod_pool_checks(name: str, probe: _PoolProbe) -> str:
    """Kernel A fwd on each recorded pool's own map and proposals (one a
    step, one a branch for MRRP: the rows of the other branches masked)
    bit-identical to its plain version on the card, masked rows 0 with no
    argmax; A bwd on the step's own gradient bit-identical to the plain
    backward run on the CPU. These launches do not count."""
    from sos_wsod_torch.kernels.roi_pool import roi_pool_fwd_cuda
    from sos_wsod_torch.kernels.roi_pool_bwd import roi_pool_bwd_cuda
    from sos_wsod_torch.ops.roi_pool import (bin_windows, roi_pool_backward_reference,
                                             roi_pool_reference)

    saved = _more_counts()
    parts = []
    for i, rec in enumerate(probe.calls):
        feat, valid = rec["feat"], rec["valid"]
        h, w, c = feat.shape
        win = bin_windows(rec["boxes"], valid, h, w, 7, 7, rec["spatial_scale"])
        out_k, pos_k = roi_pool_fwd_cuda(feat, *win, valid, rec["scale"])
        out_p, pos_p = roi_pool_reference(feat, *win, valid, rec["scale"])
        _assert_same(f"{name} A fwd, pool {i}", out_k, pos_k, out_p, pos_p)
        if bool(out_k[~valid].any()) or bool((pos_k[~valid] >= 0).any()):
            raise AssertionError(f"{name} A fwd, pool {i}: a masked row is not 0")
        rs = rec["scale"].to(feat.dtype).float()
        acc_k = roi_pool_bwd_cuda(rec["grad"].contiguous(), pos_k, rs, *win, valid, h, w)
        acc_p = roi_pool_backward_reference(rec["grad"].cpu(), pos_k.cpu(), rs.cpu(), h, w)
        if not torch.equal(acc_k.cpu(), acc_p):
            n = int((acc_k.cpu() != acc_p).sum())
            raise AssertionError(f"{name} A bwd, pool {i}: {n} cells differ from the plain "
                                 "backward run on the CPU")
        parts.append(f"pool {i}: {int(valid.sum())} of {valid.shape[0]} rows on "
                     f"{h}x{w}x{c} {feat.dtype}")
    torch.cuda.synchronize()
    _set_more_counts(saved)
    return "; ".join(parts)


def _mrrp_conv_times(device, smi: str) -> None:
    """The MRRP stage (3 x MRRPConv 512 -> 512 at dilations 1, 2, 3 on
    three branches of one stage-4 map, ReLU) at plain4's 87 x 119 x 512 on
    the 704 x 960 canvas, bf16: forward, and forward + backward (the input's
    gradient too), with each branch's conv as cuDNN's dilated conv in
    channels_last (the model's memory format, ``engine/weights.py``), in
    NCHW, and as a plain 3x3 conv on the d x d sub-grids
    (``heads/aspp.py:_conv_nchw``)."""
    import types

    from sos_wsod_torch.models.backbones import mrrp
    from sos_wsod_torch.models.heads import aspp

    gen = torch.Generator(device=device).manual_seed(SEED)
    stage = mrrp.MRRPPlainStage(512, 512, 3, (1, 2, 3), device=device)
    stage = stage.to(memory_format=torch.channels_last)
    x = (torch.randn((1, 512, 87, 119), generator=gen, device=device) * 10).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)

    def run(backward):
        with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
            out = stage(x.expand(3, *x.shape[1:]))
        if backward:
            out.float().sum().backward()

    def nchw(x, weight, bias, dilation, padding):
        return F.conv2d(x.contiguous(), weight.contiguous(), bias, padding=padding,
                        dilation=dilation)

    def sub_grids(x, weight, bias, dilation, padding):
        conv = types.SimpleNamespace(weight=weight, bias=bias, dilation=(dilation, dilation),
                                     stride=(1, 1), padding=(padding, padding))
        return aspp._conv_nchw(conv, x.contiguous())

    branch_conv = mrrp.branch_conv
    times = {}
    try:
        for name, conv in (("dilated channels_last", branch_conv), ("dilated NCHW", nchw),
                           ("sub-grids", sub_grids)):
            mrrp.branch_conv = conv
            times[name] = (cuda_ms(lambda: run(False), 10), cuda_ms(lambda: run(True), 10))
    finally:
        mrrp.branch_conv = branch_conv
    log("uwsod", "MRRP stage at 3 x 87 x 119 x 512 bf16, forward / forward + backward ms: "
        + ", ".join(f"{k} {f:.2f} / {fb:.2f}" for k, (f, fb) in times.items())
        + f" on {smi}")


def _uwsod_predict(name: str, model, smi: str) -> tuple:
    """``predict`` in bf16 on UWSOD_PREDICT_IMAGES images: finite scores of
    the test top-k's slots, detections inside the image, the launches of A
    fwd (one a branch) and C (the RPN's and the post-process's) an image, the
    first image's detections equal to the all-plain path's. Returns the
    launches an image."""
    head, nb = model.roi_heads, len(model.levels)
    dev_type = next(model.parameters()).device.type
    model.eval()

    def predict(seed):
        batch = _uwsod_batch(seed, next(model.parameters()).device, head.num_classes)
        with torch.inference_mode(), torch.autocast(dev_type, dtype=torch.bfloat16):
            return model.predict(batch)

    before = _more_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [predict(SEED + 100 + i) for i in range(UWSOD_PREDICT_IMAGES)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / UWSOD_PREDICT_IMAGES
    launches = _more_counts()
    got = tuple(a - b for a, b in zip(launches, before))
    per_image = (nb, 0, 2, 0, 0)
    if got != tuple(UWSOD_PREDICT_IMAGES * x for x in per_image):
        raise AssertionError(f"{name}: predict launches {got} over {UWSOD_PREDICT_IMAGES} "
                             f"images, expected {per_image} an image")
    h, w = UWSOD_IMAGE_HW
    for det, scores, boxes in outs:
        b = det.boxes[det.valid]
        if not (bool(torch.isfinite(scores).all()) and bool(torch.isfinite(boxes).all())
                and scores.shape == (model.proposal_generator.post_nms_topk_test,
                                     head.num_classes + 1)
                and bool((b[:, 0::2] >= 0).all() and (b[:, 0::2] <= w).all())
                and bool((b[:, 1::2] >= 0).all() and (b[:, 1::2] <= h).all())):
            raise AssertionError(f"{name} predict: scores {tuple(scores.shape)}, "
                                 f"{int(det.valid.sum())} detections {b[:4].tolist()}")
    with _plain_versions(roi_pool=True):
        plain = predict(SEED + 100)[0]
    _set_more_counts(launches)
    det = outs[0][0]
    for f in ("boxes", "scores", "classes", "valid"):
        if not torch.equal(getattr(det, f), getattr(plain, f)):
            raise AssertionError(f"{name} predict: detections' {f} differ from the all-plain "
                                 "path's")
    if not bool(det.valid.any()):
        raise AssertionError(f"{name} predict: no detection on the first image")
    log("uwsod", f"{name} predict over {UWSOD_PREDICT_IMAGES} images from the seeded weights: "
        f"{ms:.1f} ms an image (the first cold), launches (A fwd, A bwd, C, D, D bwd) an image "
        f"{per_image}; the first image's {int(det.valid.sum())} detections equal to the "
        f"all-plain path's on {smi}")
    return per_image


def _uwsod_train(name: str, model, cfg, smi: str) -> list:
    """UWSOD_STEPS + 1 SGD steps (solver/build.py) in bf16 autocast, each on
    a new image: the first cold with its pools checked by
    ``_uwsod_pool_checks``, the second with refine_mist and sampling_on
    (MIST's NMS once a branch, the subsampling), the last profiled. Every
    loss finite, the launches of each step. Returns them."""
    from sos_wsod_torch.models.meta import rcnn_uwsod
    from sos_wsod_torch.solver.build import build_optimizer

    head, nb, k = model.roi_heads, len(model.levels), model.roi_heads.refine_k
    device = next(model.parameters()).device
    model.train()
    opt, sched = build_optimizer(cfg, model)
    gen = torch.Generator(device=device).manual_seed(SEED)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    want = {"loss_cls", "loss_rpn_cls", "loss_rpn_loc"} | {
        f"loss_{t}_r{j}" for j in range(k) for t in ("cls", "box_reg")}
    steps, launches, all_losses, prof, checked = [], [], [], None, ""
    torch.cuda.reset_peak_memory_stats()
    for i in range(UWSOD_STEPS + 1):
        batch = _uwsod_batch(SEED + i, device, head.num_classes)
        head.refine_mist = head.sampling_on = i == 1
        probe = _PoolProbe(rcnn_uwsod.roi_pool) if i == 0 else None
        profiled = i == UWSOD_STEPS
        ctx = torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext()
        before = _more_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if probe is not None:
            rcnn_uwsod.roi_pool = probe
        try:
            with ctx as p:
                opt.zero_grad(set_to_none=True)
                with torch.autocast(device.type, dtype=torch.bfloat16):
                    losses = model.loss(batch, gen)
                with torch.profiler.record_function("backward"):
                    sum(losses.values()).backward()
                with torch.profiler.record_function("optimizer"):
                    opt.step()
                    sched.step()
                torch.cuda.synchronize()
        finally:
            if probe is not None:
                rcnn_uwsod.roi_pool = probe.pool
        steps.append((time.perf_counter() - t0) * 1e3)
        launches.append(tuple(a - b for a, b in zip(_more_counts(), before)))
        vals = {key: float(v.detach()) for key, v in losses.items()}
        all_losses.append(vals)
        if set(vals) != want or not np.isfinite(list(vals.values())).all():
            raise AssertionError(f"{name} step {i}: losses {vals}")
        if probe is not None:
            if len(probe.calls) != nb:
                raise AssertionError(f"{name}: {len(probe.calls)} pools in a step, expected {nb}")
            checked = _uwsod_pool_checks(name, probe)
            del probe
        if profiled:
            prof = p
    head.refine_mist = head.sampling_on = False
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_launches = [(nb, nb, 1, 0, 0)] * (UWSOD_STEPS + 1)
    want_launches[1] = (nb, nb, 1 + k, 0, 0)
    if launches != want_launches:
        raise AssertionError(f"{name}: launches (A fwd, A bwd, C, D, D bwd) per step {launches}, "
                             f"expected {want_launches}")
    host, dev, other = _range_ms(prof, UWSOD_RANGES)
    busy = sum(dev.values()) + other
    warm = statistics.median(steps[2:UWSOD_STEPS])
    dan = [getattr(head.dan, f"fc{j + 1}") for j in range(head.dan.num_fc)]
    log("uwsod", f"{name}: {nb} branch(es), K {k}, DAN "
        + " -> ".join(str(d) for d in [dan[0].in_features] + [fc.out_features for fc in dan])
        + f", RPN top-k {model.proposal_generator.pre_nms_topk_train} -> "
        f"{model.proposal_generator.post_nms_topk_train}; step ms "
        f"{[round(t, 1) for t in steps]} (the first cold, the second with refine_mist and "
        f"sampling_on, the last profiled), warm {warm:.1f} ms; peak memory {peak_gb:.2f} GB; "
        f"launches (A fwd, A bwd, C, D, D bwd) a step {launches[0]}, the MIST step "
        f"{launches[1]}; losses " + "; ".join(
            ", ".join(f"{key} {v:.4f}" for key, v in sorted(sc.items())) for sc in all_losses)
        + f" on {smi}")
    log("uwsod", f"{name} first step's pools against the plain versions, A fwd bit-identical on "
        f"the card, A bwd to the plain backward on the CPU: {checked}")
    log("uwsod", f"{name} profiled step, range host/device ms: "
        + ", ".join(f"{n} {host[n]:.2f}/{dev[n]:.2f}" for n in UWSOD_RANGES)
        + f", device outside the ranges {other:.2f}; busy {busy:.2f} of {steps[-1]:.2f} ms "
        f"({100 * busy / steps[-1]:.1f}%, profiler on) on {smi}")
    return launches


def _uwsod_model(name: str, device, smi: str, cfg) -> tuple:
    """One UWSOD model at full width with random weights from the seed:
    ``_uwsod_predict`` on them, then ``_uwsod_train`` (with random weights
    the recipe's steps drive the present classes' image scores to the 1e-6
    clamp, after which nothing is detected, so predict runs first). Returns
    the launches (A fwd, A bwd, C, D, D bwd) of both."""
    from sos_wsod_torch.engine.synthetic import build_synthetic_uwsod
    from sos_wsod_torch.models import meta

    model = build_synthetic_uwsod(getattr(meta, name), device, SEED, **UWSOD_KW)
    per_image = _uwsod_predict(name, model, smi)
    trained = [sum(x) for x in zip(*_uwsod_train(name, model, cfg, smi))]
    del model
    torch.cuda.empty_cache()
    return tuple(a + UWSOD_PREDICT_IMAGES * b for a, b in zip(trained, per_image))


def phase_uwsod(device, smi: str) -> dict:
    """The UWSOD family (UWSODRCNN, MRRPUWSODRCNN) at full width through
    their ``loss`` and ``predict`` with the port's SGD (``_uwsod_model``);
    the MRRP stage's conv forms timed (``_mrrp_conv_times``). Returns the
    launches of the two models' steps and predicts."""
    from sos_wsod_torch.engine.synthetic import load_config

    cfg = load_config(str(CONFIG), [])
    launches = (0,) * 5
    _set_more_counts(launches)
    for name in UWSOD_MODELS:
        t0 = time.perf_counter()
        got = _uwsod_model(name, device, smi, cfg)
        launches = tuple(a + b for a, b in zip(launches, got))
        _set_more_counts(launches)
        log("uwsod", f"{name}: {time.perf_counter() - t0:.1f} s")
    _mrrp_conv_times(device, smi)
    _set_more_counts(launches)
    return dict(zip(("roi_pool_fwd", "roi_pool_bwd", "nms", "roi_align_fwd", "roi_align_bwd"),
                    launches))


def _item7_counts() -> dict:
    """Launches of D fwd, D bwd and C's two kernels since they were last
    set to 0 (rotated NMS launches C's sweep alone)."""
    from sos_wsod_torch.kernels import nms, roi_align as align, roi_align_bwd as align_bwd

    return {"roi_align_fwd": align.launches, "roi_align_bwd": align_bwd.launches,
            "nms_mask": nms.mask_launches, "nms_sweep": nms.sweep_launches}


def _check_launches(name: str, got: dict, want: dict) -> dict:
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return got


def _close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """``got`` within rtol + rtol x max |want| of ``want``; returns the
    largest difference."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    err = float((got - want).abs().max())
    atol = rtol * float(want.abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: differs by up to {err:.3g} (rtol {rtol}, atol {atol:.3g})")
    return err


def _jittered_gt(sample: dict, per_gt: int, spread: float, seed: int) -> np.ndarray:
    """``per_gt`` copies of each gt box of ``sample`` with every corner moved
    by a normal draw of ``spread`` times the box's side, clipped to the
    image: proposals that mostly overlap their box at IoU 0.5-0.95, so
    that the ROI sampler's foreground quota fills as in a trained
    detector's batch."""
    rng = np.random.default_rng(seed)
    gt = sample["gt_boxes"][sample["gt_valid"]]
    side = np.tile(gt[:, 2:] - gt[:, :2], 2)[:, None]
    boxes = gt[:, None] + rng.normal(0, spread, (len(gt), per_gt, 4)) * side
    h, w = sample["image_hw"]
    return np.clip(boxes.reshape(-1, 4), 0, [w, h, w, h]).astype(np.float32)


def _item7_heads(device, smi: str) -> dict:
    """Phase 19 (a): CascadeROIHeads and MaskROIHeads on the stage-2
    detector, one synthetic image with instance masks, the RPN's proposals
    and jittered copies of the gt boxes (``_jittered_gt``). The first
    step's losses, the gradients of the pooled maps and of both heads'
    parameters with the kernels bit-identical to the plain path's (ROIAlign
    forward plain on the card, its backward plain on the CPU, cuDNN held to
    its deterministic algorithms in both)."""
    from sos_wsod_torch.core.matcher import Matcher
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_frcnn, load_config, synthetic_mask_sample)
    from sos_wsod_torch.models.roi_heads.mask_cascade import CascadeROIHeads, MaskROIHeads
    from sos_wsod_torch.models.roi_heads.standard import (
        FPN_STRIDES, add_ground_truth_to_proposals, label_and_sample_proposals)

    cfg = load_config(str(STAGE2_CONFIG), ITEM7_STAGE2_OPTS)
    roi, box = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD
    model = build_synthetic_frcnn(cfg, device, SEED).train()
    torch.manual_seed(SEED)
    kw = dict(in_features=tuple(roi.IN_FEATURES),
              strides=tuple(FPN_STRIDES[f] for f in roi.IN_FEATURES),
              in_channels=cfg.MODEL.FPN.OUT_CHANNELS, num_classes=roi.NUM_CLASSES, device=device)
    cascade = CascadeROIHeads(batch_size_per_image=roi.BATCH_SIZE_PER_IMAGE,
                              positive_fraction=roi.POSITIVE_FRACTION,
                              pooler_resolution=box.POOLER_RESOLUTION, num_fc=box.NUM_FC,
                              fc_dim=box.FC_DIM, **kw)
    mask = MaskROIHeads(**ITEM7_MASK_HEAD, **kw)
    matcher = Matcher(list(roi.IOU_THRESHOLDS), list(roi.IOU_LABELS))
    sample = synthetic_mask_sample(ITEM7_CANVAS, ITEM7_IMAGE_HW, *ITEM7_GT, roi.NUM_CLASSES, SEED)
    t = {k: torch.as_tensor(v, device=device) for k, v in sample.items()}
    jit = torch.as_tensor(_jittered_gt(sample, *ITEM7_JITTER, SEED), device=device)
    gt = (t["gt_boxes"], t["gt_classes"], t["gt_valid"])
    autocast = torch.autocast("cuda", dtype=torch.bfloat16,
                              enabled=model.compute_dtype == torch.bfloat16)

    def features():
        feats = model._features(t["image"])
        return feats, {k: v[0].permute(1, 2, 0) for k, v in feats.items()}

    def losses(seed, retain=False):
        generator = torch.Generator(device=device).manual_seed(seed)
        with autocast:
            feats, hwc = features()
            if retain:
                for k in roi.IN_FEATURES:
                    hwc[k].retain_grad()
            (pb, pl, pv), _ = model.proposal_generator.proposals(feats, t["image_hw"], train=True)
            pb, pl = torch.cat([pb, jit]), torch.cat([pl, pl.new_zeros(len(jit))])
            pv = torch.cat([pv, pv.new_ones(len(jit))])
            out = cascade.losses(hwc, pb, pl, pv, *gt, generator, t["image_hw"])
            # the mask branch over a box branch's samples (StandardROIHeads' draws)
            ab, _, av = add_ground_truth_to_proposals(pb, pl, pv, gt[0], gt[2])
            sb, scls, smatch, sv, fg, _ = label_and_sample_proposals(
                ab, av, *gt, matcher, generator, batch_size_per_image=roi.BATCH_SIZE_PER_IMAGE,
                positive_fraction=roi.POSITIVE_FRACTION, num_classes=roi.NUM_CLASSES)
            out.update(mask.losses(hwc, sb, sv, scls, fg, t["gt_masks"], smatch))
        return out, int(fg.sum()), hwc

    def first_step():
        """The first step's losses and gradients (pooled maps, then the
        cascade's and the mask head's parameters), left out of the weights."""
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            got, _, hwc = losses(SEED, retain=True)
            sum(v.float() for v in got.values()).backward()
        finally:
            torch.backends.cudnn.deterministic = saved
        grads = [hwc[k].grad for k in roi.IN_FEATURES]
        grads += [p.grad for m in (cascade, mask) for p in m.parameters()]
        opt.zero_grad(set_to_none=True)
        return {k: v.detach() for k, v in got.items()}, grads

    def predict():
        with torch.inference_mode(), autocast:
            feats, hwc = features()
            (pb, _, pv), _ = model.proposal_generator.proposals(feats, t["image_hw"])
            scores, boxes = cascade.predict_scores_boxes(hwc, pb, pv, t["image_hw"])
            best = torch.where(pv, scores[:, :-1].max(1).values, float("-inf"))
            top = torch.topk(best, ITEM7_DETECTIONS).indices
            masks = mask.predict(hwc, boxes[top], pv[top], scores[top, :-1].argmax(1))
        return scores, boxes, masks

    params = [p for m in (model, cascade, mask) for p in m.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=0.02, momentum=0.9)
    with _plain_versions(roi_align=True, roi_align_bwd=True):
        want, want_grads = first_step()
    check, check_grads = first_step()
    if not all(torch.equal(check[k], want[k]) for k in check):
        raise AssertionError(f"losses with the kernels {check} != the plain path's {want}")
    if any(a is None or b is None or not torch.equal(a, b)
           for a, b in zip(check_grads, want_grads)):
        raise AssertionError("the first step's gradients of the pooled maps or of the heads' "
                             "parameters with the kernels differ from the plain path's")
    levels = len(roi.IN_FEATURES)
    n_grads, n_nonzero = len(want_grads), [int(g.count_nonzero()) for g in want_grads[:levels]]
    del check_grads, want_grads
    _reset_align_nms_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for step in range(2):
        t0 = time.perf_counter()
        got, n_fg, _ = losses(SEED + step)
        total = sum(v.float() for v in got.values())
        total.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            first, first_fg = {k: v.detach() for k, v in got.items()}, n_fg
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    pred = predict()
    torch.cuda.synchronize()
    pred_ms = (time.perf_counter() - t0) * 1e3
    launches = _check_launches("phase 19 (a)", _item7_counts(), {
        "roi_align_fwd": 2 * 5 + 4, "roi_align_bwd": 2 * 4, "nms_mask": 3, "nms_sweep": 3})
    with _plain_versions(roi_align=True):
        plain_pred = predict()
    keys = {f"{n}_stage{k}" for n in ("loss_cls", "loss_box_reg") for k in range(3)}
    if set(first) != keys | {"loss_mask"} or not all(torch.isfinite(v) for v in first.values()):
        raise AssertionError(f"cascade + mask losses: {first}")
    if not all(torch.equal(first[k], want[k]) for k in first):
        raise AssertionError(f"losses of the SGD step {first} != the plain path's {want}")
    if first_fg < roi.BATCH_SIZE_PER_IMAGE * roi.POSITIVE_FRACTION:
        raise AssertionError(f"{first_fg} foreground samples: the quota is not filled")
    if not all(torch.equal(a, b) for a, b in zip(pred, plain_pred)):
        raise AssertionError("cascade scores, boxes or masks with the kernels differ from the "
                             "plain path's")
    scores, boxes, masks = pred
    if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()
            and bool(((masks >= 0) & (masks <= 1)).all())):
        raise AssertionError("non-finite cascade predictions or masks outside [0, 1]")
    mh = ITEM7_MASK_HEAD
    log("item7", f"(a) CascadeROIHeads (3 stages, IoU 0.5/0.6/0.7, {box.NUM_FC} x {box.FC_DIM} "
                 f"fc) + MaskROIHeads ({mh['num_conv']} x {mh['conv_dim']} convs, pooler "
                 f"{mh['pooler_resolution']} -> {2 * mh['pooler_resolution']} masks) on the "
                 f"R50-FPN, {ITEM7_IMAGE_HW} image on {ITEM7_CANVAS}, {ITEM7_GT[0]} gt with "
                 f"ellipse masks, the RPN's proposals + {len(jit)} jittered gt copies, "
                 f"{roi.BATCH_SIZE_PER_IMAGE} ROIs ({first_fg} fg): losses " +
                 ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(first.items())) +
                 f" == the plain path's; the first step's {n_grads} gradients (the pooled maps' "
                 f"nonzero entries {n_nonzero}, both heads' parameters) == the plain path's bit "
                 f"for bit; "
                 f"SGD step ({model.compute_dtype}) " +
                 " / ".join(f"{ms:.1f}" for ms in step_ms) + f" ms (cold / warm), peak "
                 f"{peak:.2f} GB; predict_scores_boxes + MaskROIHeads.predict of "
                 f"{ITEM7_DETECTIONS} detections {pred_ms:.1f} ms, == the plain path's; "
                 f"launches {launches} on {smi}")
    del model, cascade, mask, opt, params
    torch.cuda.empty_cache()
    return launches


def _item7_deform_weights(blk, x: torch.Tensor, g: torch.Generator) -> None:
    """The block's weights for the card-against-CPU check: FrozenBN
    statistics near the identity (the residual branch's last scaled to
    about 0.3), and offsets of a few pixels (the offset conv at random,
    scaled to its input's spread, its bias cancelling the input's mean)."""
    with torch.no_grad():
        for name, scale in (("conv1_norm", 1.0), ("conv2_norm", 1.0), ("conv3_norm", 0.3)):
            bn = getattr(blk, name)
            bn.weight.uniform_(0.8 * scale, 1.2 * scale, generator=g)
            bn.bias.normal_(0, 0.1, generator=g)
            bn.running_mean.normal_(0, 0.1, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
        inp = F.relu(blk.conv1_norm(blk.conv1(x)))
        w = blk.conv2_offset.weight
        w.normal_(0, ITEM7_OFFSET_GAIN / (w[0].numel() ** 0.5 * float(inp.std())), generator=g)
        blk.conv2_offset.bias.copy_(-(w.sum((2, 3)) @ inp.mean((0, 2, 3))))


_PRE_RELU = ("conv1_norm", "conv2_norm", "conv3_norm")   # the third ReLU's input adds x


def _record_pre_relu(blk, x: torch.Tensor, seen: dict) -> list:
    """Hooks that keep the input of each of the block's three ReLUs."""
    def hook(name):
        return lambda m, i, o: seen.__setitem__(
            name, (o + x if name == "conv3_norm" else o).detach())
    return [getattr(blk, n).register_forward_hook(hook(n)) for n in _PRE_RELU]


def _take_gates(blk, x: torch.Tensor, card: dict, counts: dict) -> list:
    """Hooks that give the CPU block's ReLUs the card's gates. Where the two
    devices' inputs to a ReLU lie on either side of 0, which the check
    allows only within ITEM7_KINK of the layer's largest |input| on both,
    the CPU's input takes the card's side (its size kept, so within that
    of 0), and both take the same branch of the kink. counts[name] = (the
    elements that switched, the elements within ITEM7_KINK of 0 on either
    device)."""
    def hook(name):
        def fn(m, i, o):
            pre = o + x.detach() if name == "conv3_norm" else o
            on = card[name] > 0
            eps = ITEM7_KINK * float(card[name].abs().max())
            switch = (pre > 0) != on
            if bool((switch & ((pre.abs() > eps) | (card[name].abs() > eps))).any()):
                raise AssertionError(f"{name}: a ReLU input on the card and on the CPU on either "
                                     f"side of 0 and more than {eps:.3g} from it")
            counts[name] = (int(switch.sum()),
                            int(((pre.abs() <= eps) | (card[name].abs() <= eps)).sum()))
            side = torch.where(on, pre.abs().clamp_min(torch.finfo(pre.dtype).tiny), -pre.abs())
            return o + (torch.where(switch, side, pre) - pre).detach()
        return fn
    return [getattr(blk, n).register_forward_hook(hook(n)) for n in _PRE_RELU]


def _item7_deform(device, smi: str) -> None:
    """Phase 19 (b): DeformBottleneckBlock at WS-ResNet-50's res5 width, both
    variants, on the card against the CPU; deform_conv2d at zero offsets
    against cuDNN's conv."""
    import copy

    from sos_wsod_torch.models.backbones.resnet_ws import DeformBottleneckBlock
    from sos_wsod_torch.ops.deform_conv import deform_conv2d

    h, w, c = ITEM7_DEFORM_HWC
    bott, dil = c // 4, 2
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(1, c, h, w, generator=g)
    gout = torch.randn(1, c, h, w, generator=g)
    for modulated in (False, True):
        torch.manual_seed(SEED)
        blk = DeformBottleneckBlock(c, c, bott, dilation=dil, deform_modulated=modulated)
        assert not blk.has_shortcut   # the third ReLU's input is conv3_norm's output + x
        _item7_deform_weights(blk, x, g)
        card = copy.deepcopy(blk).to(device)
        seen = {}
        hooks = [card.conv2_offset.register_forward_hook(
            lambda m, i, o: seen.__setitem__("off", o.detach()))]
        xd = x.to(device, copy=True).requires_grad_()
        hooks += _record_pre_relu(card, xd, seen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out_d = card(xd)
        (out_d * gout.to(device)).sum().backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for hk in hooks:
            hk.remove()
        # the CPU reference samples at the card's offsets (as values; their
        # gradient path stays): the bilinear's derivative jumps where a sample
        # crosses a cell edge, which two devices' f32 offsets may straddle;
        # its ReLUs take the card's gates (_take_gates) for the same reason
        off_d = seen["off"].cpu()
        blk.conv2_offset.register_forward_hook(lambda m, i, o: o + (off_d - o).detach())
        xc = x.clone().requires_grad_()   # x takes no gradient: a leaf
        kinks = {}
        _take_gates(blk, xc, {k: seen[k].cpu() for k in _PRE_RELU}, kinks)
        out_c = blk(xc)
        (out_c * gout).sum().backward()
        errs = [_close("forward", out_d, out_c, 1e-5), _close("input gradient", xd.grad, xc.grad,
                                                             1e-4)]
        for (name, pd), (_, pc) in zip(card.named_parameters(), blk.named_parameters()):
            errs.append(_close(f"{name} gradient", pd.grad, pc.grad, 1e-4))
        shift = float(off_d[:, :18].abs().median())   # the border's zero padding shifts more
        if not 0.3 < shift < 10:
            raise AssertionError(f"median |offset| {shift:.3f} px: not a few pixels")
        live = [float((seen[k] > 0).float().mean()) for k in _PRE_RELU]
        with torch.no_grad():
            fwd = cuda_ms(lambda: card(xd), 5)

        def fwd_bwd():
            card.zero_grad(set_to_none=True)
            (card(xd) * gout.to(device)).sum().backward()
        both = cuda_ms(fwd_bwd, 3)
        log("item7", f"(b) DeformBottleneckBlock {'v2 (modulated)' if modulated else 'v1'} "
                     f"{c} -> {bott} -> {c}, dilation {dil}, on {(h, w)} f32: median |offset| "
                     f"{shift:.2f} px; the three ReLUs' inputs > 0 on the card " +
                     " / ".join(f"{100 * v:.1f}%" for v in live) + f", within {ITEM7_KINK} x "
                     f"the largest of 0 on either device (of them switched to the card's side) " +
                     ", ".join(f"{k} {n} ({m})" for k, (m, n) in kinks.items()) +
                     f"; forward and every gradient within the CPU test's "
                     f"tolerance of the CPU (largest differences forward {errs[0]:.3g}, input "
                     f"gradient {errs[1]:.3g}, parameters {max(errs[2:]):.3g}); forward "
                     f"{fwd:.3f} ms, forward + backward {both:.3f} ms, peak {peak:.2f} GB on "
                     f"{smi}")
        del card, xd, out_d
    xin = torch.randn(1, bott, h, w, device=device)
    wt = torch.randn(bott, bott, 3, 3, device=device) / (9 * bott) ** 0.5
    off0 = torch.zeros(1, 18, h, w, device=device)
    got = deform_conv2d(xin, off0, wt, stride=1, padding=dil, dilation=dil)
    ref = F.conv2d(xin, wt, padding=dil, dilation=dil)
    err = _close("deform_conv2d at zero offsets vs F.conv2d", got, ref, 1e-4)
    d_ms = cuda_ms(lambda: deform_conv2d(xin, off0, wt, stride=1, padding=dil, dilation=dil), 5)
    c_ms = cuda_ms(lambda: F.conv2d(xin, wt, padding=dil, dilation=dil), 5)
    log("item7", f"(b) deform_conv2d at zero offsets ({bott} -> {bott}, 3 x 3, dilation {dil}, "
                 f"{(h, w)} f32) {d_ms:.3f} ms vs cuDNN's F.conv2d {c_ms:.3f} ms "
                 f"({d_ms / c_ms:.1f}x); outputs within 1e-4 (largest difference {err:.3g}) on "
                 f"{smi}")
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _fixed_permutation(perm: torch.Tensor):
    from sos_wsod_torch.core import sampling

    saved = sampling.permutation
    sampling.permutation = lambda n, generator, device: perm.to(device)
    try:
        yield
    finally:
        sampling.permutation = saved


def _item7_roi_label(device, smi: str) -> None:
    """Phase 19 (c): roi_label at ITEM7_ROI_LABEL ROIs and classes, on the
    card and on the CPU with one permutation."""
    from sos_wsod_torch.core.boxes import pairwise_iou
    from sos_wsod_torch.ops.roi_label import roi_label

    r, c = ITEM7_ROI_LABEL
    rng = np.random.default_rng(SEED)
    xy = rng.uniform(0, 800, (r, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(20, 300, (r, 2))], 1)
                             .astype(np.float32))
    cpu = {"scores": torch.from_numpy(rng.uniform(0, 1, (r, c + 1)).astype(np.float32)),
           "iou": pairwise_iou(boxes, boxes),
           "labels": torch.from_numpy((rng.uniform(0, 1, c) < 0.15).astype(np.float32)),
           "valid": torch.arange(r) < r - 96}
    cpu["labels"][int(rng.integers(c))] = 1.0
    card = {k: v.to(device) for k, v in cpu.items()}
    perm = torch.randperm(r, generator=torch.Generator().manual_seed(SEED))
    with _fixed_permutation(perm):
        want = roi_label(*cpu.values(), torch.Generator())
        got = roi_label(*card.values(), torch.Generator(device=device))
        ms = cuda_ms(lambda: roi_label(*card.values(), None), 5)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise AssertionError("roi_label on the card differs from the CPU")
    log("item7", f"(c) roi_label at {r} ROIs x {c} classes ({int(cpu['labels'].sum())} present): "
                 f"RL and RW on the card == the CPU's ({int((want[1] > 0).sum())} weighted, "
                 f"{int((want[0] == c).sum())} background); {ms:.3f} ms on {smi}")


def _rotated_boxes(rng, n: int, span: float) -> np.ndarray:
    """n random-angle boxes, a third of them jittered copies of others."""
    b = np.concatenate([rng.uniform(0, span, (n, 2)), rng.uniform(10, 80, (n, 2)),
                        rng.uniform(-180, 180, (n, 1))], 1)
    k = n // 3
    b[:k] = b[k:2 * k] + rng.normal(0, [2, 2, 2, 2, 5], (k, 5))
    return b.astype(np.float32)


def _item7_rotated(device, smi: str) -> dict:
    """Phase 19 (d): the rotated IoU on the card against the CPU, and rotated
    NMS through kernel C's sweep against the plain fixpoint."""
    from sos_wsod_torch.ops.nms import greedy_keep_from_suppression
    from sos_wsod_torch.ops.rotated import nms_rotated_mask, pairwise_iou_rotated

    n_iou, n_nms = ITEM7_ROTATED
    rng = np.random.default_rng(SEED)
    b = torch.from_numpy(_rotated_boxes(rng, n_iou, 600.0))
    want = pairwise_iou_rotated(b, b)
    bd = b.to(device)
    got = pairwise_iou_rotated(bd, bd)
    err = float((got.cpu() - want).abs().max())
    n_diff = int((got.cpu() != want).sum())
    if err > 1e-5:
        raise AssertionError(f"rotated IoU on the card differs from the CPU by {err:.3g}")
    iou_ms = cuda_ms(lambda: pairwise_iou_rotated(bd, bd), 3)

    b = torch.from_numpy(_rotated_boxes(rng, n_nms, 800.0))
    scores = torch.from_numpy(rng.uniform(0, 1, n_nms).astype(np.float32))
    valid = torch.ones(n_nms, dtype=torch.bool)
    card = [b.to(device), scores.to(device), valid.to(device)]
    _reset_align_nms_counts()
    keep = nms_rotated_mask(*card, 0.5)
    torch.cuda.synchronize()
    launches = _check_launches("phase 19 (d)", _item7_counts(), {
        "roi_align_fwd": 0, "roi_align_bwd": 0, "nms_mask": 0, "nms_sweep": 1})
    # the plain fixpoint over the same suppression relation, on the CPU
    order = torch.sort(scores, descending=True, stable=True).indices
    bs = card[0][order.to(device)]
    suppress = (pairwise_iou_rotated(bs, bs) > 0.5).cpu() & torch.ones(
        n_nms, n_nms, dtype=torch.bool).triu(1)
    plain = torch.zeros(n_nms, dtype=torch.bool).scatter(
        0, order, greedy_keep_from_suppression(suppress, valid[order]))
    if not torch.equal(keep.cpu(), plain):
        raise AssertionError(f"rotated NMS through the sweep keeps {int(keep.sum())}, the plain "
                             f"fixpoint {int(plain.sum())}")
    nms_ms = cuda_ms(lambda: nms_rotated_mask(*card, 0.5), 3)
    log("item7", f"(d) pairwise_iou_rotated {n_iou} x {n_iou} on the card within {err:.3g} of the "
                 f"CPU ({n_diff} of {n_iou * n_iou} pairs not bit-identical), {iou_ms:.3f} ms; "
                 f"nms_rotated_mask at {n_nms} boxes (IoU 0.5) through "
                 f"kernel C's sweep: keeps {int(keep.sum())}, == the plain fixpoint's over the "
                 f"same IoU matrix; {nms_ms:.3f} ms; launches {launches} on {smi}")
    return launches


class _HookTrainer:
    """What LossEvalHook reads of a trainer: its step and its storage."""

    def __init__(self, storage, it: int):
        self.storage, self.iter = storage, it


def _item7_loss_eval(device, smi: str) -> dict:
    """Phase 19 (e): LossEvalHook over 2 validation batches of the stage-2
    model, against the model's own "val_loss" totals."""
    from sos_wsod_torch.engine.hooks import LossEvalHook, batch_generator
    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_frcnn, load_config, synthetic_mask_sample)
    from sos_wsod_torch.engine.ubteacher import stack_samples
    from sos_wsod_torch.utils.events import EventStorage

    cfg = load_config(str(STAGE2_CONFIG), ITEM7_STAGE2_OPTS)
    model = build_synthetic_frcnn(cfg, device, SEED)
    n_batches, per_batch = ITEM7_VAL
    samples = [synthetic_mask_sample(ITEM7_CANVAS, ITEM7_IMAGE_HW, *ITEM7_GT,
                                     cfg.MODEL.ROI_HEADS.NUM_CLASSES, SEED + 1 + i)
               for i in range(n_batches * per_batch)]
    batches = [stack_samples(samples[i:i + per_batch], device)
               for i in range(0, len(samples), per_batch)]
    hook = LossEvalHook(1, model, lambda: iter(batches), max_batches=n_batches)
    hook.trainer = _HookTrainer(EventStorage(0), 0)
    _reset_align_nms_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hook.after_step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n_images = n_batches * per_batch
    launches = _check_launches("phase 19 (e)", _item7_counts(), {
        "roi_align_fwd": n_images, "roi_align_bwd": 0, "nms_mask": n_images,
        "nms_sweep": n_images})
    logged = hook.trainer.storage.latest()["val_total_loss_student"][0]
    totals = []
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                         enabled=model.compute_dtype == torch.bfloat16):
        for i, b in enumerate(batches):
            losses = model(b, branch="val_loss", generator=batch_generator(device, 0, i))
            totals.append(sum(v.float() for v in losses.values()))
    want = float(torch.stack(totals).double().mean())
    if logged != want or not np.isfinite(want):
        raise AssertionError(f"LossEvalHook logged {logged}, the model's own mean {want}")
    log("item7", f"(e) LossEvalHook over {n_batches} batches of {per_batch} images: "
                 f"val_total_loss_student {logged:.6f} == the mean of the model's own val_loss "
                 f"totals ({', '.join(f'{float(x):.6f}' for x in totals)}); {ms:.1f} ms; "
                 f"launches {launches} on {smi}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_item7(device, smi: str) -> dict:
    """The modules no JAX entry point reaches: (a) the cascade and mask
    heads, (b) DeformBottleneckBlock and deform_conv2d, (c) roi_label, (d)
    the rotated IoU and NMS, (e) LossEvalHook. Returns the launches of D
    fwd, D bwd and C (C's sweep: rotated NMS launches it alone)."""
    total = {}
    for part in (_item7_heads, _item7_deform, _item7_roi_label, _item7_rotated,
                 _item7_loss_eval):
        t0 = time.perf_counter()
        for k, v in (part(device, smi) or {}).items():
            total[k] = total.get(k, 0) + v
        log("item7", f"{part.__name__}: {time.perf_counter() - t0:.1f} s")
    _reset_align_nms_counts()
    log("item7", f"launches {total} (C's mask kernel {total['nms_mask']}, its sweep "
                 f"{total['nms_sweep']})")
    return {"roi_align_fwd": total["roi_align_fwd"], "roi_align_bwd": total["roi_align_bwd"],
            "nms": total["nms_sweep"]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _pool_nms_counts() -> dict:
    """A fwd, A bwd and C launches since their counts were last set to 0."""
    from sos_wsod_torch.kernels import roi_pool, roi_pool_bwd

    return {"roi_pool_fwd": roi_pool.launches, "roi_pool_bwd": roi_pool_bwd.launches,
            "nms": _nms_launches()}


def _reset_pool_nms_counts() -> None:
    from sos_wsod_torch.kernels import roi_pool, roi_pool_bwd

    roi_pool.launches = roi_pool_bwd.launches = 0
    _reset_nms_launches()


def _device_of(device: str) -> torch.device:
    return torch.device(device, 0) if device == "cuda" else torch.device(device)


def _entry_forward(device, smi: str) -> dict:
    """(a) ``sos_wsod_torch.entry.entry()``: the flagship OICR+ forward at
    the JAX entry's sizes (P = 512, 256 x 320, full DAN, f32) on the card;
    its shapes, A fwd and C once, every output equal to the all-plain
    path's; the warm forward's time."""
    from sos_wsod_torch.entry import entry

    fn, (model, batch) = entry(_device_of(device))
    _reset_pool_nms_counts()
    out = fn(model, batch)
    _sync(device)
    counts = _pool_nms_counts()
    shapes = [tuple(o.shape) for o in out]
    if counts != {"roi_pool_fwd": 1, "roi_pool_bwd": 0, "nms": 1}:
        raise AssertionError(f"entry: launches {counts}, want A fwd 1 and C 1")
    if shapes != [(512, 21), (512, 80), (100, 4), (100,)] or \
            not all(torch.isfinite(o).all() for o in out):
        raise AssertionError(f"entry: outputs of shapes {shapes}, finite "
                             f"{[bool(torch.isfinite(o).all()) for o in out]}")
    with _plain_versions(roi_pool=True):
        plain = fn(model, batch)
    if not all(torch.equal(a, b) for a, b in zip(out, plain)):
        raise AssertionError("entry: the forward differs from the all-plain path's")
    times = []
    for _ in range(5):
        _sync(device)
        t0 = time.perf_counter()
        fn(model, batch)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    log("entry", f"entry(): outputs {shapes}, finite, equal to the all-plain path's; A fwd "
                 f"{counts['roi_pool_fwd']}, C {counts['nms']}; warm forward "
                 f"{statistics.median(times[1:]):.2f} ms (median of 4, f32, host clock after a "
                 f"synchronize) on {smi}")
    del model, out, plain
    if device == "cuda":
        torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def _split_in_one_process(tp: int):
    """``DAN.forward`` as ``tp`` tensor-parallel ranks compute it, all in
    this process: fc1's rows and fc2's columns in ``tp`` shards, the mask
    after fc1 drawn whole once and sliced, fc2's partial products rounded
    to the compute dtype and summed in rank order, its bias added after.
    The split's arithmetic without its collectives, to tell its sum order
    from a fault."""
    from sos_wsod_torch.models.heads import dan as dan_mod

    forward = dan_mod.DAN.forward

    def split(self, x, generator=None):
        x = x.reshape(x.shape[0], -1)
        n = self.fc1.weight.shape[0] // tp
        rows = [slice(r * n, (r + 1) * n) for r in range(tp)]
        h = [F.relu(F.linear(x, self.fc1.weight[s], self.fc1.bias[s])) for s in rows]
        if self.training and self.dropout_rate:
            keep = torch.rand((x.shape[0], n * tp), generator=generator,
                              device=x.device) >= self.dropout_rate
            h = [hr * keep[:, s].to(hr.dtype) * (1.0 / (1.0 - self.dropout_rate))
                 for hr, s in zip(h, rows)]
        parts = [F.linear(hr, self.fc2.weight[:, s].contiguous()) for hr, s in zip(h, rows)]
        y = parts[0]
        for part in parts[1:]:
            y = y + part
        y = y + self.fc2.bias.to(y.dtype)
        x = dan_mod.dropout(F.relu(y), self.dropout_rate, self.training, generator)
        for i in range(2, self.num_fc):
            x = dan_mod.dropout(F.relu(getattr(self, f"fc{i + 1}")(x)), self.dropout_rate,
                                self.training, generator)
        return x

    dan_mod.DAN.forward = split
    try:
        yield
    finally:
        dan_mod.DAN.forward = forward


def _tp_step(device, smi: str) -> dict:
    """(b) Tensor parallelism at full width: voc07_oicr_plus.yaml (VGG16,
    DAN 25088 -> 4096 -> 4096, K = 4, P = 4096, bf16), ``TP_WORLD`` gloo
    ranks sharing the card as dp1 x tp2 (``check_ddp.run_tasks``), 3 steps
    of one image from the seeded weights, dropout 0.5. The first step
    against one process's step on the card from the same weights, batch and
    seed: total_loss and loss_cls within 1%, the gathered fc1 after the
    update within rtol 1e-2 / atol 1e-5 (the JAX package's bound on its
    tensor-parallel fc1), the kernels' launches a rank equal to the one
    process's; fc2's difference is printed beside its largest update. And
    against the same step in one process with the ranks' arithmetic
    (``_split_in_one_process``: fc2's sum split and ordered as theirs):
    losses, fc1 and fc2 bit-identical. The second step timed warm, the
    third's all-reduces traced; the checkpoint the ranks wrote after the
    first step (the one-process layout) loads into one process's
    trainer."""
    from sos_wsod_torch.engine.checkpoint import Checkpointer
    from sos_wsod_torch.engine.launch import launch
    from sos_wsod_torch.engine.synthetic import build_synthetic_model, load_config
    from sos_wsod_torch.tools import check_ddp

    dev = _device_of(device)
    opts = ["SOLVER.IMS_PER_BATCH", 1, *TP_OPTS]
    cfg = load_config(str(CONFIG), opts)
    model = build_synthetic_model(cfg, dev, SEED)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the global batches, mapped once here for the ranks and this process
    batches = check_ddp.stage1_batches(cfg, TP_STEPS, RAW_HW, NUM_PROPOSALS, SEED)
    spec = {"kind": "stage1", "config": str(CONFIG), "opts": opts, "model": state,
            "dan_dropout": 0.5, "batches": batches}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tp.pt")
        torch.save(dict(spec, tp=TP_WORLD, snapshot_at=1, trace_at=2, save_at=1,
                        report_model=False), path)
        os.makedirs(os.path.join(tmp, "report"))
        t0 = time.perf_counter()
        launch(check_ddp.run_tasks, TP_WORLD,
               args=([{"name": "tp", "cli": "steps", "spec": path, "out_dir": tmp}],
                     os.path.join(tmp, "report"), tmp),
               backend="gloo", device=device)
        secs_ranks = time.perf_counter() - t0
        ranks = [r[0] for r in check_ddp.load_reports(os.path.join(tmp, "report"), TP_WORLD)]

        # one process, same weights, batches and seed: plainly, then with
        # the ranks' arithmetic
        one = {}
        for name, ctx in (("plain", contextlib.nullcontext()),
                          ("split", _split_in_one_process(TP_WORLD))):
            one_model, trainer = check_ddp.build_trainer(spec, batches)
            _reset_pool_nms_counts()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with ctx:
                trainer.train(0, 1)
            _sync(dev)
            hist = trainer.storage.histories()
            one[name] = {
                "launches": _pool_nms_counts(),
                "peak": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0,
                "fc": {k: v.detach().float().cpu().clone()
                       for k, v in one_model.state_dict().items()
                       if k.startswith("roi_heads.dan.fc")},
                "losses": {k: hist[k].values()[0][0] for k in ("total_loss", "loss_cls")}}
            if name == "plain":
                t0 = time.perf_counter()
                trainer.train(1, 2)
                _sync(dev)
                one_ms = (time.perf_counter() - t0) * 1e3
                ckpt = Checkpointer(os.path.join(tmp, "checkpoints")).load("model_0000000",
                                                                           map_location=dev)
                trainer.load_state_dict(ckpt)   # strict: the one-process layout
                if trainer.steps_done != 1:
                    raise AssertionError(f"the ranks' checkpoint resumed at {trainer.steps_done}")
                del ckpt
            del trainer, one_model
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    one_launches = one["plain"]["launches"]
    for r, e in enumerate(ranks):
        if e["tp"] != TP_WORLD or [x["iter"] for x in e["records"]] != list(range(TP_STEPS)):
            raise AssertionError(f"tp rank {r}: tp {e['tp']}, steps {e['records']}")
        first = {k: e["records"][0]["launches"][k] for k in one_launches}
        if first != one_launches or one["split"]["launches"] != one_launches:
            raise AssertionError(f"tp rank {r}: launches of the first step {first}, one "
                                 f"process's {one_launches}, split in one process "
                                 f"{one['split']['launches']}")
    losses = {k: ranks[0]["scalars"][k][0][1] for k in ("total_loss", "loss_cls")}
    snap = {k: ranks[0]["snapshot"][k].float() for k in one["plain"]["fc"]}
    rel = {k: abs(v - one["plain"]["losses"][k]) / abs(one["plain"]["losses"][k])
           for k, v in losses.items()}
    if max(rel.values()) > 1e-2:
        raise AssertionError(f"tp step losses {losses} against one process's "
                             f"{one['plain']['losses']}")
    if losses != one["split"]["losses"] or \
            any(not torch.equal(snap[k], v) for k, v in one["split"]["fc"].items()):
        raise AssertionError(
            f"tp step against its arithmetic in one process: losses {losses} vs "
            f"{one['split']['losses']}, largest fc differences "
            f"{ {k: float((snap[k] - v).abs().max()) for k, v in one['split']['fc'].items()} }")
    diffs = {}
    for k, want in one["plain"]["fc"].items():
        diffs[k] = (float((snap[k] - want).abs().max()), float((want - state[k]).abs().max()))
        if k.startswith("roi_heads.dan.fc1") and \
                not torch.allclose(snap[k], want, rtol=1e-2, atol=1e-5):
            raise AssertionError(f"tp step {k}: largest difference {diffs[k][0]}")
    w = ranks[0]["records"]
    trace = ranks[0]["tp_trace"]
    peaks = ", ".join(f"{e.get('peak_gb', 0):.2f}" for e in ranks)
    log("tp", f"dp1 x tp{TP_WORLD}, {TP_WORLD} gloo ranks sharing one card (not a scaling "
              f"figure; the ranks {secs_ranks:.1f} s): step 1 equals, bit for bit (losses, fc1, "
              f"fc2), one process's step run with the ranks' split of fc2's sum; against one "
              f"process's own step: total_loss and loss_cls within "
              f"{rel['total_loss']:.2e} / {rel['loss_cls']:.2e} relative (bound 1e-2), each "
              f"weight's largest difference after the update beside its largest update: " +
        "; ".join(f"{k.split('.', 2)[-1]} {d:.3e} / {u:.3e}" for k, (d, u) in diffs.items()) +
        f" (fc1 within rtol 1e-2 / atol 1e-5); launches a rank and step {w[0]['launches']} "
        f"(one process {one_launches}); the checkpoint loads into one process's trainer")
    log("tp", f"warm step {w[1]['ms']:.1f} ms a rank (one process's warm step {one_ms:.1f} ms), "
              f"the traced step {w[2]['ms']:.1f} ms; peak {peaks} GB by rank (one process "
              f"{one['plain']['peak']:.2f} GB); each "
              f"all-reduce of the traced step on rank 0 (synchronized alone, gloo through the "
              f"host): " + "; ".join(f"{x['op']} {x['shape']} {x['dtype']} {x['bytes'] / 1e6:.1f} "
                                     f"MB {x['ms']:.1f} ms" for x in trace) + f" on {smi}")
    launches = {k: v + one["split"]["launches"][k] for k, v in one_launches.items()}
    for e in ranks:
        for k in launches:
            launches[k] += e["launches"][k]
    return launches


def _dryrun(device, smi: str) -> dict:
    """(c) ``dryrun_multichip(DRYRUN_RANKS)``: gloo ranks sharing the card
    (fewer cards than ranks), the data-parallel step and the dp1 x tp4
    step, within the JAX bound of each other."""
    from sos_wsod_torch.entry import dryrun_multichip
    from sos_wsod_torch.tools import check_ddp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dryrun_multichip(DRYRUN_RANKS, device, out_dir=tmp)
        secs = time.perf_counter() - t0
        reports = check_ddp.load_reports(tmp, DRYRUN_RANKS)
    r = reports[0]
    launches = {k: sum(x["launches"][k] for x in reports) for k in ("roi_pool_fwd",
                                                                     "roi_pool_bwd", "nms")}
    log("dryrun", f"dryrun_multichip({DRYRUN_RANKS}) on the card ({secs:.1f} s, gloo ranks "
                  f"sharing it): total_loss {r['dp']['total_loss']:.6f}, dp1 x tp{r.get('tp')} "
                  f"{r.get('dp_tp', {}).get('total_loss', float('nan')):.6f}; launches of the "
                  f"ranks {launches} on {smi}")
    return launches


def _readers(device, smi: str) -> dict:
    """(d) The weight readers on the card: caffe2 R-50 blobs (pickled, from
    the seed) into voc_baseline's R50-FPN ``bottom_up`` and d2 VGG16 blobs
    into the OICR+ model, each followed by one forward; a blob of another
    shape raises."""
    import pickle

    from sos_wsod_torch.engine.synthetic import (
        build_synthetic_frcnn, load_config, random_c2_resnet_blobs, random_d2_wsl_blobs,
        synthetic_test_samples)
    from sos_wsod_torch.engine.weights import (
        load_resnet_imagenet_weights, load_vgg_wsl_weights, state_dict_from_c2_resnet)
    from sos_wsod_torch.kernels import roi_align
    from sos_wsod_torch.models.meta.rcnn_wsl import MultiInputRCNN

    dev = _device_of(device)
    launches = {}

    def refused(load, model, path) -> str:
        try:
            load(model, path)
        except ValueError as e:
            return str(e)
        raise AssertionError(f"{load.__name__}: a blob of another shape was taken")

    with tempfile.TemporaryDirectory() as tmp:
        cfg2 = load_config(str(STAGE2_CONFIG), READER_STAGE2_OPTS)
        frcnn = build_synthetic_frcnn(cfg2, dev, SEED)
        blobs = random_c2_resnet_blobs(frcnn.state_dict(), SEED + 1)
        path = os.path.join(tmp, "R-50.pkl")
        with open(path, "wb") as f:
            pickle.dump(blobs, f)
        t0 = time.perf_counter()
        load_resnet_imagenet_weights(frcnn, path)
        secs_r50 = time.perf_counter() - t0
        want = state_dict_from_c2_resnet(blobs)
        own = frcnn.state_dict()
        if not all(torch.equal(own[k].cpu(), v) for k, v in want.items()):
            raise AssertionError("R-50 reader: the bottom_up entries differ from the blobs")
        sample = synthetic_test_samples(cfg2, 1, RAW_HW, NUM_PROPOSALS, SEED)[0][0]
        roi_align.launches = 0
        _reset_nms_launches()
        with torch.inference_mode(), torch.autocast(dev.type, dtype=torch.bfloat16,
                                                    enabled=frcnn.compute_dtype == torch.bfloat16):
            det = frcnn.predict(_stage2_batch(sample, dev))[0]
        _sync(dev)
        launches.update(roi_align_fwd=roi_align.launches, nms=_nms_launches())
        if not torch.isfinite(det.scores.float()).all():
            raise AssertionError("R-50 reader: non-finite scores")
        bad = dict(blobs, res3_0_branch2b_w=blobs["res3_0_branch2b_w"][:, :-1])
        with open(path, "wb") as f:
            pickle.dump(bad, f)
        msg_r50 = refused(load_resnet_imagenet_weights, frcnn, path)
        del frcnn, own, want

        cfg1 = load_config(str(CONFIG), READER_STAGE1_OPTS)
        model = MultiInputRCNN.from_cfg(cfg1, device=dev).eval()
        d2 = random_d2_wsl_blobs(SEED + 2, cfg1.MODEL.ROI_HEADS.NUM_CLASSES, cfg1.WSL.REFINE_NUM,
                                 cfg1.MODEL.ROI_BOX_HEAD.DAN_DIM)
        path = os.path.join(tmp, "vgg16_d2.pkl")
        with open(path, "wb") as f:
            pickle.dump({"model": d2}, f)
        t0 = time.perf_counter()
        load_vgg_wsl_weights(model, path)
        secs_vgg = time.perf_counter() - t0
        sample = synthetic_test_samples(cfg1, 1, RAW_HW, NUM_PROPOSALS, SEED)[0][0]
        _reset_pool_nms_counts()
        with torch.inference_mode(), torch.autocast(dev.type, dtype=torch.bfloat16,
                                                    enabled=model.compute_dtype == torch.bfloat16):
            det = model.predict(_stage2_batch(sample, dev))[0]
        _sync(dev)
        counts = _pool_nms_counts()
        if counts != {"roi_pool_fwd": 1, "roi_pool_bwd": 0, "nms": 1} or \
                not torch.isfinite(det.scores.float()).all():
            raise AssertionError(f"VGG16 reader: launches {counts}, finite "
                                 f"{bool(torch.isfinite(det.scores.float()).all())}")
        launches["roi_pool_fwd"] = counts["roi_pool_fwd"]
        launches["nms"] += counts["nms"]
        d2["roi_heads.box_head.fc2.weight"] = d2["roi_heads.box_head.fc2.weight"][:-1]
        with open(path, "wb") as f:
            pickle.dump({"model": d2}, f)
        msg_vgg = refused(load_vgg_wsl_weights, model, path)
        del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log("readers", f"caffe2 R-50 blobs ({len(blobs)}) into voc_baseline's R50-FPN bottom_up in "
                   f"{secs_r50:.2f} s, equal to the blobs, then predict (D fwd "
                   f"{launches['roi_align_fwd']}, C {launches['nms'] - counts['nms']}); d2 "
                   f"VGG16 blobs ({len(d2)}) into OICR+ in {secs_vgg:.2f} s, then predict (A fwd "
                   f"{counts['roi_pool_fwd']}, C {counts['nms']}); a blob of another shape "
                   f"raises: {msg_r50!r}; {msg_vgg!r}; on {smi}")
    return launches


def phase_finish(smi: str, device: str = "cuda") -> dict:
    """Phase 20: the entry points, tensor parallelism and the weight
    readers, (a)-(d) (see the module's docstring), on ``device`` ("cuda";
    "cpu" for a rehearsal). Returns the kernels' launches of its paths, the
    ranks' included."""
    totals = dict.fromkeys(KERNELS, 0)
    for part in (_entry_forward, _tp_step, _dryrun, _readers):
        t0 = time.perf_counter()
        for k, v in part(device, smi).items():
            totals[k] += v
        log("finish", f"{part.__name__}: {time.perf_counter() - t0:.1f} s")
    return totals


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
    more_launches = timed("16 CSC, WS-ResNet-50, ROIAlignV2", phase_single_view_more, device,
                          smi)
    wsjds_launches = timed("17 WSJDS", phase_wsjds, device, smi)
    uwsod_launches = timed("18 UWSOD", phase_uwsod, device, smi)
    item7_launches = timed("19 item-7 modules", phase_item7, device, smi)
    finish_launches = timed("20 entry points, tensor parallelism, readers", phase_finish, smi)
    paths = {"stage-1 inference": infer_launches, "stage-1 training": train_launches,
             "stage-1 CLI": cli_launches, "stage-2 inference and CLI": stage2_launches,
             "stage-2 training": stage2_train_launches,
             "stage-3 split and training": stage3_train_launches,
             "pipeline and TTA": pipeline_launches, "data parallel": ddp_launches,
             "single-view heads": single_launches,
             "CSC, WS-ResNet-50, ROIAlignV2": more_launches, "WSJDS": wsjds_launches,
             "UWSOD": uwsod_launches, "item-7 modules": item7_launches,
             "entry points, tensor parallelism, readers": finish_launches}
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
