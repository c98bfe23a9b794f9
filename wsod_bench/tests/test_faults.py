"""A run with the timed path broken underneath reads ``correct`` false:
the harness's whole run but the look for a card, on tiny images with the
box heads at their published widths on the CPU, once for each fault the
cell can have (``faults.py``); the same run unbroken reads true."""
from __future__ import annotations

import pytest
import torch

from wsod_bench import faults
from wsod_bench.tests.tiny import BENCH_CELLS, WIDE_OPTS, run_tiny, tiny_cell

FAULTS = {"train": ("unchanged_state", "half_batch", "altered_answer"),
          "infer": ("altered_answer", "box_decode")}
CASES = [(cell, fault) for cell in BENCH_CELLS
         for fault in FAULTS[tiny_cell(cell).traffic["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_reads_not_correct(cell, fault):
    torch.set_num_threads(2)
    with faults.planted(fault, tiny_cell(cell).traffic["driver"]):
        line = run_tiny(cell, opts=WIDE_OPTS)
    assert not line["correct"], line["checks"]
    box = line["checks"].get("box_shift")
    if fault == "box_decode" and box is not None:   # the box check fails by itself
        assert box["value"] > box["limit"], box


def test_sound_run_reads_correct():
    torch.set_num_threads(2)
    assert run_tiny(BENCH_CELLS[0], opts=WIDE_OPTS)["correct"]
