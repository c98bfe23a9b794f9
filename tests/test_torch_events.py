"""The port's metric store and hooks (sos_wsod_torch/utils/events.py,
engine/hooks.py) against the JAX package's: a trainer loop that logs the same
scalars drives IterationTimer and PeriodicWriter with both writers, and gives
the same smoothed values, metrics.json lines and console lines. Plain Python
on both sides: exact, except the wall-clock ``time`` readings.
"""
from __future__ import annotations

import json
import logging

import numpy as np

from sos_wsod_tpu.engine import hooks as jhooks
from sos_wsod_tpu.engine.trainer import TrainerBase as JaxTrainerBase
from sos_wsod_tpu.utils import events as jev
from sos_wsod_torch.engine import hooks as thooks
from sos_wsod_torch.engine.trainer import TrainerBase
from sos_wsod_torch.utils import events as tev


def _run(base, hooks, events, json_path, values):
    class Loop(base):
        def run_step(self):
            for k, v in values[self.iter].items():
                self.storage.put_scalar(k, v, smoothing_hint=k != "lr")

    loop = Loop()
    writers = [events.CommonMetricPrinter(max_iter=len(values)), events.JSONWriter(json_path)]
    loop.register_hooks([hooks.IterationTimer(warmup_iter=2), hooks.PeriodicWriter(writers, 3)])
    loop.train(0, len(values))
    return loop


def test_storage_writers_and_hooks_match_jax(tmp_path, caplog):
    rng = np.random.RandomState(0)
    values = [{"loss_cls": float(rng.rand()), "total_loss": float(rng.rand()),
               "data_time": float(rng.rand()), "lr": 0.01 * (i + 1)} for i in range(7)]
    lines = {}
    for tag, base, hooks, events in (("port", TrainerBase, thooks, tev),
                                     ("jax", JaxTrainerBase, jhooks, jev)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            loop = _run(base, hooks, events, str(tmp_path / tag / "metrics.json"), values)
        assert loop.iter == 7
        # the console line up to the wall-clock step time
        lines[tag] = [r.getMessage().split("  time:")[0].split("iter:")[1]
                      for r in caplog.records if "iter:" in r.getMessage()]
        smoothed = loop.storage.latest_with_smoothing()
        assert len(loop.storage.histories()["time"]._values) == 5   # 7 steps, 2 warm-up
        lines[tag + "_smoothed"] = {k: v for k, v in smoothed.items() if k != "time"}
        lines[tag + "_json"] = [{k: v for k, v in json.loads(line).items() if k != "time"}
                                for line in (tmp_path / tag / "metrics.json").read_text()
                                .splitlines()]
    assert len(lines["port"]) >= 3
    for key in ("", "_smoothed", "_json"):
        assert lines["port" + key] == lines["jax" + key], key
