"""What the port's benchmarks and ``chip_smoke.py`` share to time a kernel on
the card and set its time beside its bound."""
from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Median device time of one call of ``fn`` over ``iters`` calls, by
    CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
