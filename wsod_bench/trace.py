"""The profiler's record of a traced sub-window, reduced to plain lists.

``Trace.take(prof)`` keeps, from ``torch.profiler``'s raw events:
  - ``device``: every operation on the card (kernels, copies, sets) as
    (name, start, end) in ns;
  - ``ranges``: the host's ``record_function`` ranges and the CUDA runtime
    calls as (name, start, end, thread);
  - ``dtoh``: the correlation ids of the runtime calls that copied from the
    card to the host.
Kernels the port launches through ctypes carry no link to a host op; they
are found by name.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

BENCH_PREFIX = "bench."


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, int, int]]
    ranges: List[Tuple[str, int, int, int]]
    runtime: List[Tuple[str, int, int, bool]]   # (name, start, end, copies to the host)
    wall_s: float
    units: int          # steps or images in the traced sub-window

    @classmethod
    def take(cls, prof, wall_s: float, units: int) -> "Trace":
        from torch.autograd import DeviceType

        raw = prof.profiler.kineto_results.events()
        device, ranges, runtime, dtoh = [], [], [], set()
        for e in raw:
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
                if "DtoH" in e.name() or "Device -> Pageable" in e.name():
                    dtoh.add(e.linked_correlation_id())
        for e in raw:
            if e.device_type() != DeviceType.CPU:
                continue
            name, end = e.name(), e.start_ns() + e.duration_ns()
            if name.startswith("cuda"):
                runtime.append((name, e.start_ns(), end, e.correlation_id() in dtoh))
            elif "::" not in name:
                ranges.append((name, e.start_ns(), end, e.start_thread_id()))
        device.sort(key=lambda d: d[1])
        return cls(device, ranges, runtime, wall_s, units)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals."""
        out: List[List[int]] = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, names: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names)) / 1e9

    def range_host_s(self, names: Iterable[str]) -> Dict[str, float]:
        names = set(names)
        out = dict.fromkeys(names, 0.0)
        for n, s, e, _ in self.ranges:
            if n in names:
                out[n] += (e - s) / 1e9
        return out

    def covered_host_s(self, names: Iterable[str]) -> float:
        """Host seconds inside any range named in ``names`` (nested or
        overlapping ranges counted once)."""
        names = set(names)
        spans = sorted((s, e) for n, s, e, _ in self.ranges if n in names)
        total, end = 0, None
        for s, e in spans:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def blocked_host_s(self) -> float:
        """Host seconds in runtime calls that wait for the card: the
        synchronizes, and the copies to the host; those inside the
        benchmark's own ranges are left out."""
        own = [(s, e) for n, s, e, _ in self.ranges if n.startswith(BENCH_PREFIX)]
        total = 0
        for n, s, e, to_host in self.runtime:
            if ("Synchronize" in n or to_host) and not any(a <= s <= b for a, b in own):
                total += e - s
        return total / 1e9

    def top_device_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e9
        return [[n[:120], t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_by_host(self, k: int = 10) -> List[List]:
        """The device's idle time between operations, by the innermost
        host range open at each gap's middle (its longest total first)."""
        busy = self.busy_intervals()
        spans = sorted(((s, e, n) for n, s, e, _ in self.ranges
                        if not n.startswith(BENCH_PREFIX)), key=lambda r: r[0])
        starts = [r[0] for r in spans]
        by: Dict[str, float] = {}
        for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "outside ranges"
            # the latest-starting range still open at mid is the innermost
            for j in range(i, max(i - 4096, -1), -1):
                if spans[j][1] >= mid:
                    name = spans[j][2]
                    break
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[n[:120], t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]
