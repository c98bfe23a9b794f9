"""The control of each cell's comparison fails at a size a test run
holds: the plain reference in float8 put in the system's place, on the
cell's tiny inputs but at the published box-head widths, reads a number
beyond its limit on every seed tried."""
from __future__ import annotations

import pytest
import torch

from wsod_bench import control
from wsod_bench.tests.tiny import BENCH_CELLS, WIDE_OPTS, tiny_cell


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_control_fails(cell, seed):
    torch.set_num_threads(4)
    c = tiny_cell(cell)
    got = control.numbers(c, seed, "cpu", WIDE_OPTS)
    assert any(got[k] > float(v) for k, v in c.limits.items()), (got, c.limits)
