"""Trainer hooks: HookBase, IterationTimer and PeriodicWriter.

Counterpart of the same classes in ``sos_wsod_tpu/engine/hooks.py``
(detectron2's hook surface). Checkpointing, evaluation and profiling hooks
are not ported yet.
"""
from __future__ import annotations

import logging
import time
from typing import List

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None  # set by TrainerBase.register_hooks

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """Puts each step's seconds as ``time`` after ``warmup_iter`` steps, and
    logs the mean over the rest at the end."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = 0.0
        self._step_start = 0.0
        self._done_iters = 0

    def before_train(self):
        self._start_time = time.perf_counter()

    def after_train(self):
        total = time.perf_counter() - self._start_time
        n = max(self._done_iters - self._warmup_iter, 1)
        logger.info("Total training time: %.1fs (%.4f s/iter over %d iters)", total, total / n, n)

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        dt = time.perf_counter() - self._step_start
        self._done_iters += 1
        if self._done_iters > self._warmup_iter:
            self.trainer.storage.put_scalar("time", dt, smoothing_hint=True)


class PeriodicWriter(HookBase):
    """Writes the storage through ``writers`` every ``period`` steps, at the
    last step and at the end of training."""

    def __init__(self, writers: List, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            for w in self._writers:
                w.write(self.trainer.storage)

    def after_train(self):
        for w in self._writers:
            w.write(self.trainer.storage)
            w.close()
