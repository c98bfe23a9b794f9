"""The FLOP and byte arithmetic of ``work/`` against counts made by hand at
small shapes."""
from __future__ import annotations

import pytest
import torch

from wsod_bench.models import frcnn as frcnn_family
from wsod_bench.models import stage1 as stage1_family
from wsod_bench.reference.ops import bin_windows
from wsod_bench.work import flops, peaks, roofline


def test_vgg16_layers_by_hand():
    # 16 x 24 input: plain1 at 16 x 24, pool to 8 x 12, plain2, pool to
    # 4 x 6, plain3, pool to 2 x 3, plain4 (pool stride 1: 1 x 2), plain5
    got = flops.vgg16_layers(16, 24)
    sizes = [(16, 24)] * 2 + [(8, 12)] * 2 + [(4, 6)] * 3 + [(2, 3)] * 3 + [(1, 2)] * 3
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
             (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
    want = [2 * ci * co * 9 * h * w for (h, w), (ci, co) in zip(sizes, chans)]
    assert [f for _, f in got] == want


def test_heads_and_train_step_by_hand():
    rows, dan, nc, k = 10, [32, 16], 20, 2
    fwd = 2 * rows * (25088 * 32 + 32 * 16) + k * 2 * rows * 16 * (21 + 80) + 2 * 2 * rows * 16 * 20
    assert flops.head_fwd(rows, dan, nc, k, True) == fwd
    views = [(16, 24)] * 4
    layers = flops.vgg16_layers(16, 24)
    frozen = sum(f for s, f in layers if s in ("plain1", "plain2"))
    trained = [f for s, f in layers if s not in ("plain1", "plain2")]
    # forward of all, weight and input gradients of the trained, no input
    # gradient for the first trained conv
    per_view = frozen + sum(trained) + 2 * sum(trained) - trained[0]
    assert flops.stage1_train_step(views, 5, dan, nc, k) == \
        4 * per_view + 3 * flops.head_fwd(20, dan, nc, k, True)


def test_r50_fpn_stem_and_head_by_hand():
    # depth with no blocks isolates the stem and the box head
    h, w = 64, 96
    stem = 2 * 3 * 64 * 49 * 32 * 48
    head = 2 * 7 * (256 * 49 * 1024 + 1024 * 1024) + 2 * 7 * 1024 * (21 + 80)
    full = flops.r50_fpn_predict(h, w, 7, 256, [1024, 1024], 20)
    blocks = flops.r50_fpn_predict(h, w, 0, 256, [1024, 1024], 20) - stem
    assert full - blocks - stem == pytest.approx(head)
    assert stem < full


def test_roi_pool_bytes_and_bounds_by_hand():
    h, w, c, p, res = 10, 12, 8, 3, 7
    fwd = h * w * c * 2 + p * (16 + 1 + 4) + p * res * res * c * (2 + 4)
    assert roofline.roi_pool_fwd(h, w, c, p, res, 2, True, 0) == fwd / peaks.HBM_BYTES_PER_S
    bwd = p * res * res * c * (2 + 4) + p * 4 + h * w * c * 2
    assert roofline.roi_pool_bwd(h, w, c, p, res, 2) == pytest.approx(
        max(bwd / peaks.HBM_BYTES_PER_S, 2 * p * res * res * c / peaks.F32_FLOPS))


def test_roi_pool_window_cells_by_brute_force():
    boxes = torch.tensor([[0.0, 0.0, 80.0, 64.0], [8.0, 16.0, 9.0, 17.0], [30.0, 5.0, 95.0, 70.0]])
    valid = torch.tensor([True, True, False])
    row = {"hwc": (10, 12, 8), "itemsize": 2, "boxes": boxes, "valid": valid, "res": 7,
           "scale": 1 / 8, "grad": False}
    hs, he, ws, we = bin_windows(boxes, valid, 10, 12, 7, 1 / 8)
    cells = sum(int(max(int(he[i, a] - hs[i, a]), 0) * max(int(we[i, b] - ws[i, b]), 0))
                for i in range(2) for a in range(7) for b in range(7))
    bound = stage1_family.roi_pool_bounds([row], backward=False)
    assert bound == roofline.roi_pool_fwd(10, 12, 8, 3, 7, 2, False, cells)


def test_roi_align_samples_by_hand():
    # one valid box 64 x 32 on p2 (stride 4): 16 x 8 cells, bins of 16/7 x
    # 8/7, ceil -> 3 x 2 samples a bin
    boxes = torch.tensor([[0.0, 0.0, 64.0, 32.0], [0.0, 0.0, 10.0, 10.0]])
    row = {"levels": [(40, 60, 4), (20, 30, 4), (10, 15, 4), (5, 8, 4)], "itemsize": 2,
           "strides": (4, 8, 16, 32), "boxes": boxes, "valid": torch.tensor([True, False]),
           "kw": {"output_size": 7, "aligned": True, "sampling_ratio": 0}}
    want = roofline.roi_align_fwd(row["levels"], 1, 2, 7, 2, 3 * 2 * 49)
    assert frcnn_family.roi_align_bounds([row]) == want
    nbytes = (40 * 60 + 20 * 30 + 10 * 15 + 5 * 8) * 4 * 2 + 2 * 17 + 2 * 49 * 4 * 2
    assert want == max(nbytes / peaks.HBM_BYTES_PER_S, 9 * 3 * 2 * 49 * 4 / peaks.F32_FLOPS)
