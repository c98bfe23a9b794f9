"""The plain reference against the system at a tiny size on the CPU, in
float32: the whole harness (set-up, window, the reference's own mapping
and model) reads no gap beyond rounding."""
from __future__ import annotations

import pytest
import torch

from wsod_bench import run
from wsod_bench.reference import ops
from wsod_bench.tests.tiny import BENCH_CELLS, CPU_OPTS, run_tiny, tiny_cell


@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_reference_agrees_with_the_system(cell):
    torch.set_num_threads(2)
    line = run_tiny(cell)
    assert line["correct"], line["checks"]
    for name, v in line["checks"].items():
        assert v["value"] <= 1e-4, (name, v)


def test_look_reads_no_gap_on_the_cpu():
    """``calibrate.py --look``'s rerun, following the system's seed weights
    too, and the seed weights' gaps read rounding alone in float32."""
    torch.set_num_threads(2)
    ctx = run.Context(tiny_cell("oicr_plus.train"), 7, 0.5, False, "cpu", 0.0,
                      overrides=list(CPU_OPTS), log=lambda msg: None, look=True)
    look = ctx.cell.driver().run(ctx)["look"]
    assert max(look["weights_followed"].values()) <= 1e-4, look["weights_followed"]
    assert all(b["weight_gap"] <= 1e-4 for b in look["seed_look"]), look["seed_look"]


def test_roi_pool_equals_the_systems_plain_version():
    from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool_reference

    g = torch.Generator().manual_seed(3)
    feat = torch.randn(11, 13, 16, generator=g)
    x1 = torch.rand(40, generator=g) * 90
    y1 = torch.rand(40, generator=g) * 80
    boxes = torch.stack([x1, y1, x1 + torch.rand(40, generator=g) * 40,
                         y1 + torch.rand(40, generator=g) * 40], 1)
    valid = torch.arange(40) < 35
    scale = torch.rand(40, generator=g) + 1
    want = roi_pool_reference(feat, *bin_windows(boxes, valid, 11, 13, 7, 7, 1 / 8), valid,
                              scale)[0]
    got = ops.roi_pool(feat, boxes, valid, scale)
    assert torch.equal(got, want)
