"""Training metrics: the EventStorage scalar store and its writers.

Counterpart of ``sos_wsod_tpu/utils/events.py`` (detectron2's EventStorage,
CommonMetricPrinter and JSONWriter), with the same keys and the same
smoothing: a writer reports the median of each scalar over its window.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class HistoryBuffer:
    """The last ``window`` (value, iteration) pairs of a scalar and the
    latest value."""

    def __init__(self, window: int = 20):
        self._values = deque(maxlen=window)
        self.latest = None

    def update(self, value: float, iteration: int):
        self._values.append((value, iteration))
        self.latest = value

    def values(self) -> List[Tuple[float, int]]:
        return list(self._values)

    def median(self) -> float:
        vals = sorted(v for v, _ in self._values)
        return vals[len(vals) // 2] if vals else 0.0


class EventStorage:
    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._history: Dict[str, HistoryBuffer] = defaultdict(lambda: HistoryBuffer(window))
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_iter: Dict[str, int] = {}

    def put_scalar(self, name: str, value, smoothing_hint: bool = True):
        self._history[name].update(float(value), self.iter)
        self._smoothing_hints[name] = smoothing_hint
        self._latest_iter[name] = self.iter

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint)

    def histories(self):
        return self._history

    def latest(self):
        return {k: (h.latest, self._latest_iter[k]) for k, h in self._history.items()}

    def latest_with_smoothing(self):
        return {k: (h.median() if self._smoothing_hints.get(k, True) else h.latest,
                    self._latest_iter[k]) for k, h in self._history.items()}

    def step(self):
        self.iter += 1

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass


class EventWriter:
    def write(self, storage: EventStorage):
        raise NotImplementedError

    def close(self):
        pass


class CommonMetricPrinter(EventWriter):
    """Logs the iteration, the smoothed losses, step and data time, and lr."""

    def __init__(self, max_iter: Optional[int] = None):
        self._max_iter = max_iter

    def write(self, storage: EventStorage):
        it = storage.iter
        latest = storage.latest_with_smoothing()
        data_time = latest.get("data_time", (None,))[0]
        step_time = latest.get("time", (None,))[0]
        lr = latest.get("lr", (None,))[0]
        eta = ""
        if self._max_iter and step_time:
            eta = f"eta: {datetime.timedelta(seconds=int(step_time * (self._max_iter - it)))}  "
        losses = "  ".join(f"{k}: {v:.4g}" for k, (v, _) in latest.items() if "loss" in k)
        msg = f"{eta}iter: {it}  {losses}"
        if step_time is not None:
            msg += f"  time: {step_time:.4f}"
        if data_time is not None:
            msg += f"  data_time: {data_time:.4f}"
        if lr is not None:
            msg += f"  lr: {lr:.6g}"
        logger.info(msg)


class JSONWriter(EventWriter):
    """Appends one JSON line per iteration with the smoothed scalars."""

    def __init__(self, json_file: str):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")

    def write(self, storage: EventStorage):
        to_save = defaultdict(dict)
        for k, (v, it) in storage.latest_with_smoothing().items():
            to_save[it + 1][k] = v
        for it, scalars in to_save.items():
            scalars["iteration"] = it
            self._file.write(json.dumps(scalars, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
