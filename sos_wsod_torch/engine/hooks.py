"""Trainer hooks: HookBase, IterationTimer, PeriodicWriter, CheckpointHook,
EvalHook and LRSchedulerHook.

Counterpart of the same classes in ``sos_wsod_tpu/engine/hooks.py``
(detectron2's hook surface). The profiler hook is not ported: the port's
layers carry torch.profiler ranges instead. In a process group the CLIs
give PeriodicWriter to rank 0 only, the checkpointer writes on rank 0, and
EvalHook evaluates on rank 0 while the others wait (every rank holds the
same weights; two ranks must not write one detection JSON).
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

from ..evaluation.testing import flatten_results_dict
from ..parallel import comm

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


class CheckpointHook(HookBase):
    """Steps a ``PeriodicCheckpointer`` over the trainer's state after each
    step; the final save is the periodic checkpointer's ``max_iter`` rule."""

    def __init__(self, periodic_checkpointer):
        self._pc = periodic_checkpointer

    @property
    def checkpointer(self):
        """The ``Checkpointer`` the saves go through."""
        return self._pc.checkpointer

    def after_step(self):
        self._pc.step(self.trainer.iter, self.trainer.state_dict)


class EvalHook(HookBase):
    """Runs ``eval_fn`` after every ``eval_period``-th step except the last,
    and once after training when training reached ``max_iter``; puts the
    flattened results ("<dataset>/bbox/AP50", ...) as unsmoothed scalars.
    In a process group rank 0 evaluates and the others wait for it."""

    def __init__(self, eval_period: int, eval_fn: Callable[[], Optional[dict]]):
        self._period = eval_period
        self._fn = eval_fn

    def _do_eval(self):
        if comm.is_main_process():
            results = self._fn()
            if results:
                self.trainer.storage.put_scalars(smoothing_hint=False,
                                                 **flatten_results_dict(results))
        comm.synchronize()

    def after_step(self):
        it = self.trainer.iter
        if self._period > 0 and (it + 1) % self._period == 0 and it != self.trainer.max_iter - 1:
            self._do_eval()

    def after_train(self):
        # only when training reached max_iter, so that an exception in a
        # step is not followed by an eval of a half-trained model
        if self.trainer.iter + 1 >= self.trainer.max_iter:
            self._do_eval()


class LRSchedulerHook(HookBase):
    """Puts ``lr``, the learning rate of the optimizer's first parameter
    group for the step, as read before it: the schedule itself steps inside
    ``Stage1Trainer.run_step``."""

    def before_step(self):
        self._lr = self.trainer.optimizer.param_groups[0]["lr"]

    def after_step(self):
        self.trainer.storage.put_scalar("lr", self._lr, smoothing_hint=False)
