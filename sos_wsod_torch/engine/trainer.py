"""Training loop: the hook-driven TrainerBase and the stage-1 OICR+ trainer.

Counterpart of ``sos_wsod_tpu/engine/trainer.py`` (``TrainerBase``,
``make_stage1_train_step``, ``Stage1Trainer``), eager PyTorch in place of one
jitted step:
  - each image of a batch runs ``MultiInputRCNN.loss`` under bf16 autocast
    when TPU.COMPUTE_DTYPE is bfloat16; losses and metrics are averaged over
    the batch, and ``total_loss`` sums the keys starting with "loss";
  - gradients accumulate over WSL.ITER_SIZE steps as their mean (the JAX
    package's optax.MultiSteps), then clipping, SGD and the LR schedule
    step once;
  - a non-finite total raises FloatingPointError before its backward;
  - dropout draws from a torch.Generator seeded with max(SEED, 0);
  - ``state_dict``/``load_state_dict`` carry what a resumed run needs:
    model, optimizer, LR schedule, the dropout generator, ``iter`` (steps
    completed) and gradients accumulated towards an update.
Each image's backward runs right after its forward, so only one image's
activations are alive at a time. Profiler ranges: ``h2d``, ``backward``,
``optimizer`` and those of ``MultiInputRCNN.loss``.
"""
from __future__ import annotations

import logging
import time
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function

from ..solver.build import build_optimizer, clip_gradients
from ..utils.events import EventStorage
from .hooks import HookBase

logger = logging.getLogger(__name__)


class TrainerBase:
    def __init__(self):
        self._hooks: List[HookBase] = []
        self.iter: int = 0
        self.start_iter: int = 0
        self.max_iter: int = 0
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks: List[Optional[HookBase]]):
        hooks = [h for h in hooks if h is not None]
        for h in hooks:
            assert isinstance(h, HookBase)
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    def train(self, start_iter: int, max_iter: int):
        logger.info("Starting training from iteration %d", start_iter)
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        with EventStorage(start_iter) as self.storage:
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    self.before_step()
                    self.run_step()
                    self.after_step()
                    self.storage.step()
                self.iter += 1
            finally:
                self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        if self.storage is not None:
            self.storage.iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.before_step()

    def after_step(self):
        for h in self._hooks:
            h.after_step()

    def run_step(self):
        raise NotImplementedError


class Stage1Trainer(TrainerBase):
    """OICR+ multi-input trainer. ``data_iter`` yields a list of mapped
    samples (``data.build.batched_stream``) or one sample; ``model`` is a
    ``MultiInputRCNN``, and batches go to the device of its parameters."""

    def __init__(self, cfg, model, data_iter):
        super().__init__()
        self.cfg = cfg
        self.model = model.train()
        self.data_iter = data_iter
        self.device = next(model.parameters()).device
        self.optimizer, self.scheduler = build_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.iter_size = max(1, int(cfg.WSL.ITER_SIZE or 1))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(max(cfg.SEED, 0))
        self._micro_steps = 0
        self.steps_done = 0

    def run_step(self):
        t0 = time.perf_counter()
        batch = next(self.data_iter)
        samples = batch if isinstance(batch, list) else [batch]
        data_time = time.perf_counter() - t0

        self.model.train()
        bf16 = self.model.compute_dtype == torch.bfloat16
        n = len(samples)
        per_image = []
        for sample in samples:
            with record_function("h2d"):
                b = {k: torch.as_tensor(v, device=self.device)
                     for k, v in sample.items() if k != "image_id"}
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bf16):
                losses = self.model.loss(b, self.generator)
            total = sum(v for k, v in losses.items() if k.startswith("loss"))
            if not torch.isfinite(total):
                raise FloatingPointError(f"Loss became {float(total.detach())} at iteration "
                                         f"{self.iter}")
            with record_function("backward"):
                (total / (n * self.iter_size)).backward()
            per_image.append({**{k: v.detach() for k, v in losses.items()},
                              "total_loss": total.detach()})

        self._micro_steps += 1
        if self._micro_steps % self.iter_size == 0:
            with record_function("optimizer"):
                clip_gradients(self.cfg, self.params)
                self.optimizer.step()
                self.scheduler.step()
                self.optimizer.zero_grad(set_to_none=True)

        keys = list(per_image[0])
        means = torch.stack([torch.stack([m[k] for m in per_image]).mean() for k in keys])
        self.storage.put_scalar("data_time", data_time)
        for k, v in zip(keys, means.tolist()):
            self.storage.put_scalar(k, v)
        self.steps_done = self.iter + 1

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs; ``iter`` is the number of steps done.
        Gradients accumulated towards the next update (WSL.ITER_SIZE > 1)
        are kept too."""
        pending = self._micro_steps % self.iter_size
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.generator.get_state(), "iter": self.steps_done,
                "accumulated": {"micro_steps": pending,
                                "grads": [p.grad for p in self.params] if pending else None}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` (tensors on the model's device)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"].cpu())
        self.steps_done = int(state["iter"])
        acc = state["accumulated"]
        self._micro_steps = acc["micro_steps"]
        for p, g in zip(self.params, acc["grads"] or [None] * len(self.params)):
            p.grad = g
