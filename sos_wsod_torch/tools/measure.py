"""What the port's benchmarks and ``chip_smoke.py`` share to time a kernel on
the card and set its time beside its bound."""
from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict, List

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12        # the same card's f32 rate outside the tensor cores


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_bound_ms(ops: int) -> float:
    """The least time the card could take for ``ops`` f32 operations."""
    return ops / F32_OPS_PER_S * 1e3


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


def device_ms(fn: Callable[[], object], iters: int, sleep_cycles: int = 5_000_000) -> float:
    """Median device time of one call of ``fn``, without the host's time to
    enqueue it: a spin kernel (``torch.cuda._sleep``, about 3 ms) holds the
    stream while the host enqueues the start event, ``fn`` and the end
    event, so the events time only the work ``fn`` queued. For kernels whose
    launch takes the host longer than the device takes to run them."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
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


def compiler_report(lib_path) -> str:
    """The register and spill lines of a build's ptxas report, which
    ``kernels.build`` keeps beside the library."""
    log = lib_path.with_name(lib_path.name + ".log")
    lines = log.read_text().splitlines() if log.is_file() else []
    return "\n".join(ln.strip() for ln in lines if "registers" in ln or "spill" in ln)


def in_turns(fns: Dict[str, Callable[[], object]], iters: int,
             timer: Callable[[Callable[[], object], int], float] = cuda_ms
             ) -> Dict[str, List[float]]:
    """Median ms of each callable by ``timer``, visited in order and then in
    reverse."""
    labels = list(fns)
    times = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        times[label].append(timer(fns[label], iters))
    return times


def fmt_turns(times: Dict[str, List[float]]) -> str:
    return " | ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in v) + " ms"
                      for k, v in times.items())
