"""Stage-2/3 trainers: the plain baseline trainer (stage 2) and the
Unbiased-Teacher trainer's burn-in (the supervised steps of stage 3).

Counterpart of ``sos_wsod_tpu/engine/ubteacher.py`` (ubteacher's
BaselineTrainer and UBTeacherTrainer), eager PyTorch in place of jitted
steps:
  - a supervised step (``make_supervised_step``'s counterpart) stacks the
    batch's samples, runs ``GeneralizedRCNN.losses`` under bf16 autocast
    when TPU.COMPUTE_DTYPE is bfloat16 (the mean over the images of each
    loss), sums the losses into ``total_loss``, raises FloatingPointError on
    a non-finite total before its backward, then steps SGD and the LR
    schedule (``solver/build.py``);
  - the sampling draws come from a torch.Generator seeded with max(SEED, 0);
  - ``UBTeacherTrainer`` keeps a ``teacher`` copy of the model made when it
    is built, as the JAX trainer's state does, and trains on ``label_k`` (or
    ``label_q + label_k`` with SEMISUPNET.BURN_UP_WITH_STRONG_AUG) while
    the iteration is below SEMISUPNET.BURN_UP_STEP. The semi-supervised step
    after burn-in is not ported: it raises;
  - ``state_dict``/``load_state_dict`` carry what a resumed run needs.
Profiler ranges: ``h2d``, ``backward``, ``optimizer`` and those of
``GeneralizedRCNN.losses``.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..solver.build import build_optimizer, clip_gradients
from .trainer import TrainerBase

# the keys a step hands to the model; the rest (image_id, orig_hw, ...) is
# host-side metadata
MODEL_BATCH_KEYS = ("image", "image_hw", "gt_boxes", "gt_classes", "gt_valid", "multi_label_oh")


def filter_model_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in batch.items() if k in MODEL_BATCH_KEYS}


def stack_samples(samples: List[Dict[str, np.ndarray]], device) -> Dict[str, torch.Tensor]:
    """Mapped samples on one canvas -> their model keys stacked on ``device``."""
    keys = filter_model_batch(samples[0])
    return {k: torch.as_tensor(np.stack([s[k] for s in samples]), device=device) for k in keys}


class BaselineTrainer(TrainerBase):
    """Stage-2 supervised trainer. ``data_iter`` yields lists of mapped
    samples on one canvas (the loader's ``label_k``); ``model`` is a
    ``GeneralizedRCNN``, and batches go to the device of its parameters."""

    def __init__(self, cfg, model, data_iter):
        super().__init__()
        self.cfg = cfg
        self.model = model.train()
        self.data_iter = data_iter
        self.device = next(model.parameters()).device
        self.optimizer, self.scheduler = build_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(max(cfg.SEED, 0))
        self.steps_done = 0

    def supervised_step(self, samples: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
        """One SGD step on ``samples``; returns the mean losses and
        ``total_loss``, detached."""
        self.model.train()
        with record_function("h2d"):
            batch = stack_samples(samples, self.device)
        bf16 = self.model.compute_dtype == torch.bfloat16
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bf16):
            losses = self.model.losses(batch, self.generator)
        total = sum(v.float() for v in losses.values())
        if not torch.isfinite(total):
            raise FloatingPointError(f"Loss became {float(total.detach())} at iteration "
                                     f"{self.iter}")
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            clip_gradients(self.cfg, self.params)
            self.optimizer.step()
            self.scheduler.step()
            self.optimizer.zero_grad(set_to_none=True)
        return {**{k: v.detach() for k, v in losses.items()}, "total_loss": total.detach()}

    def next_samples(self) -> List[Dict[str, np.ndarray]]:
        return next(self.data_iter)

    def run_step(self):
        t0 = time.perf_counter()
        samples = self.next_samples()
        data_time = time.perf_counter() - t0
        metrics = self.supervised_step(samples)
        self.storage.put_scalar("data_time", data_time)
        keys = list(metrics)
        for k, v in zip(keys, torch.stack([metrics[k] for k in keys]).tolist()):
            self.storage.put_scalar(k, v)
        self.steps_done = self.iter + 1

    def eval_model(self):
        """The model ``--eval-only`` and the eval hook evaluate."""
        return self.model

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs; ``iter`` is the number of steps done."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.generator.get_state(), "iter": self.steps_done}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` (tensors on the model's device)."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"].cpu())
        self.steps_done = int(state["iter"])


class UBTeacherTrainer(BaselineTrainer):
    """Unbiased Teacher. ``data_iter`` yields the two-crop loader's batches
    {label_q, label_k, unlabel_q, unlabel_k}. Below SEMISUPNET.BURN_UP_STEP
    each step is the supervised step on label_k (label_q + label_k with
    BURN_UP_WITH_STRONG_AUG); the teacher is a frozen copy of the model as
    built, evaluated when SEMISUPNET.EVAL_TEACHER is set."""

    def __init__(self, cfg, model, data_iter):
        super().__init__(cfg, model, data_iter)
        self.burn_up_step = cfg.SEMISUPNET.BURN_UP_STEP
        self.burn_up_with_strong = cfg.SEMISUPNET.BURN_UP_WITH_STRONG_AUG
        self.teacher = copy.deepcopy(model).eval().requires_grad_(False)

    def next_samples(self) -> List[Dict[str, np.ndarray]]:
        if self.iter >= self.burn_up_step:
            raise NotImplementedError(
                f"iteration {self.iter} >= SEMISUPNET.BURN_UP_STEP {self.burn_up_step}: the "
                "semi-supervised step (EMA teacher, pseudo-labels, unsupervised losses) is not "
                "ported yet; it is the next slice (ROADMAP Queue 1 item 4.3)")
        batch = next(self.data_iter)
        return (batch["label_q"] + batch["label_k"] if self.burn_up_with_strong
                else batch["label_k"])

    def eval_model(self):
        return self.teacher if self.cfg.SEMISUPNET.EVAL_TEACHER else self.model

    def state_dict(self) -> Dict[str, Any]:
        return {**super().state_dict(), "teacher": self.teacher.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.teacher.load_state_dict(state["teacher"])
