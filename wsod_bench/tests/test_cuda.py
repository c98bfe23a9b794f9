"""Each cell run as the driver runs it, for a short window, on the card.
Skips without an NVIDIA GPU (decided inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from wsod_bench import spec
from wsod_bench.tests.tiny import BENCH_CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch.cuda.is_available() is False")
    out = subprocess.run([sys.executable, "-m", "wsod_bench", "--workload", cell, "--seed",
                          "2147483990", "--seconds", "2", "--trace", str(trace)],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line["checks"]
