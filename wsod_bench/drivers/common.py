"""What the drivers share: the record a traced run hands the per-layer
metrics' readers, the result's device entry, and the window's synchronize."""
from __future__ import annotations

import dataclasses
import os
import resource
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from ..trace import Trace


@dataclasses.dataclass
class Observed:
    """``kind`` "train" (units are steps) or "infer" (images); ``trace`` of
    the profiled sub-window; ``calls`` the operations' calls recorded in
    it; ``settings`` the model's numbers; ``family`` its module. The
    measured window of the same run gives ``window_flops``, ``window_s``
    and, for training, each step's ``data_time`` and ``step_ms``."""
    kind: str
    trace: Trace
    calls: Dict[str, list]
    settings: Dict
    family: object
    window_flops: float = 0.0
    window_s: float = 0.0
    chips: int = 1
    data_time: Optional[List[float]] = None
    step_ms: Optional[List[float]] = None

    def breakdown(self) -> Dict:
        return {"device_ops": self.trace.top_device_ops(), "idle_gaps": self.trace.idle_by_host()}


def usage() -> tuple:
    """This process's CPU seconds (user and system) and its involuntary
    context switches so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime, r.ru_nivcsw


def usage_line(before: tuple, wall: float) -> str:
    """What this process did on the host over ``wall`` seconds since
    ``before`` (``usage()``)."""
    cpu, switches = (b - a for a, b in zip(before, usage()))
    return (f"[host] process CPU {cpu:.2f} s over {wall:.2f} s, {switches} involuntary "
            f"switches; {os.cpu_count()} CPUs, {torch.get_num_threads()} intra-op threads")


def sync(dev) -> None:
    if dev.type == "cuda":
        with record_function("bench.sync"):
            torch.cuda.synchronize(dev)


def device_line(dev, count: int, peak: int) -> Dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": int(peak)}
