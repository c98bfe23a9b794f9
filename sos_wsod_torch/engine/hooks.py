"""Trainer hooks: HookBase, IterationTimer, PeriodicWriter, CheckpointHook,
EvalHook, LRSchedulerHook and LossEvalHook.

Counterpart of the same classes in ``sos_wsod_tpu/engine/hooks.py``
(detectron2's hook surface). The profiler hook is not ported: the port's
layers carry torch.profiler ranges instead. In a process group the CLIs
give PeriodicWriter to rank 0 only, the checkpointer writes on rank 0, and
EvalHook evaluates on rank 0 while the others wait (every rank holds the
same weights; two ranks must not write one detection JSON), or, for a
model split over tensor-parallel groups, on every rank, each evaluating
its share and rank 0 the whole.
"""
from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

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
    In a process group rank 0 evaluates and the others wait for it; with
    ``all_ranks`` every rank calls ``eval_fn`` (a collective evaluation,
    whose results rank 0 returns)."""

    def __init__(self, eval_period: int, eval_fn: Callable[[], Optional[dict]],
                 all_ranks: bool = False):
        self._period = eval_period
        self._fn = eval_fn
        self._all_ranks = all_ranks

    def _do_eval(self):
        if self._all_ranks or comm.is_main_process():
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


def batch_generator(device, seed: int, i: int) -> torch.Generator:
    """The generator of validation batch ``i``, seeded from (``seed``, i)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(np.random.SeedSequence((seed, i)).generate_state(1)[0]))
    return generator


class LossEvalHook(HookBase):
    """Every ``eval_period`` steps, the mean over at most ``max_batches``
    validation batches of the total of ``model``'s "val_loss" branch (its
    losses without the gt among the proposals) under no_grad, put as
    ``val_total_loss_student``; when the trainer has a ``teacher``, that
    model's too, as ``val_total_loss_teacher`` (ubteacher's LossEvalHook).
    ``val_iter_fn()`` yields batches as the model's ``losses`` takes them
    (``engine/ubteacher.py:stack_samples``); batch i draws its sampling from
    ``batch_generator(device, 0, i)``, the same draws for both models. Runs
    under bf16 autocast when the model computes in bf16, as the trainers
    do."""

    def __init__(self, eval_period: int, model, val_iter_fn: Callable[[], Iterable],
                 max_batches: int = 25):
        self._period = eval_period
        self._model = model
        self._val_iter_fn = val_iter_fn
        self._max_batches = max_batches

    def compute(self, model) -> float:
        """The mean total "val_loss" of ``model`` over the validation batches."""
        device = next(model.parameters()).device
        totals = []
        with torch.no_grad(), torch.autocast(device.type, dtype=torch.bfloat16,
                                             enabled=model.compute_dtype == torch.bfloat16):
            for i, batch in enumerate(itertools.islice(self._val_iter_fn(), self._max_batches)):
                losses = model(batch, branch="val_loss",
                               generator=batch_generator(device, 0, i))
                totals.append(sum(v.float() for v in losses.values()))
        return float(torch.stack(totals).double().mean()) if totals else 0.0

    def after_step(self):
        if self._period <= 0 or (self.trainer.iter + 1) % self._period != 0:
            return
        self.trainer.storage.put_scalar("val_total_loss_student", self.compute(self._model),
                                        smoothing_hint=False)
        teacher = getattr(self.trainer, "teacher", None)
        if teacher is not None:
            self.trainer.storage.put_scalar("val_total_loss_teacher", self.compute(teacher),
                                            smoothing_hint=False)
