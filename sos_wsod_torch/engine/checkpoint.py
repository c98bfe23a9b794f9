"""Checkpoints: the trainer's state in ``torch.save`` files, resumable.

Counterpart of ``sos_wsod_tpu/engine/checkpoint.py`` (detectron2's
Checkpointer and PeriodicCheckpointer), ``torch.save`` in place of orbax.
Files are ``<output_dir>/<name>.pth`` (``model_{iter:07d}``, ``model_final``)
and a ``last_checkpoint`` marker names the newest. In a process group only
rank 0 writes them, the other ranks wait at a barrier, and every rank loads
onto its own device. A trainer's state holds the module's own
``state_dict`` (no DDP prefix), in the one-process layout under tensor
parallelism too, so a checkpoint of any world size and tensor-parallel
size loads in any other and in ``--eval-only``.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Optional

import torch

from ..parallel import comm

logger = logging.getLogger(__name__)


class Checkpointer:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.saved = []   # the names this process wrote

    def path(self, name: str) -> str:
        """The file of checkpoint ``name``, with or without ``.pth``."""
        return os.path.join(self.output_dir, name if name.endswith(".pth") else name + ".pth")

    def save(self, name: str, state: Dict[str, Any]) -> None:
        """Write ``state`` and the marker on rank 0; in a process group every
        rank returns once the file is written."""
        if comm.is_main_process():
            path = self.path(name)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
            with open(os.path.join(self.output_dir, "last_checkpoint"), "w") as f:
                f.write(os.path.basename(path))
            self.saved.append(os.path.basename(path))
            logger.info("Saved checkpoint to %s", path)
        comm.synchronize()

    def load(self, name: str, map_location=None) -> Dict[str, Any]:
        return torch.load(self.path(name), map_location=map_location, weights_only=True)

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.output_dir, "last_checkpoint"))

    def get_last_checkpoint(self) -> Optional[str]:
        """The name in the ``last_checkpoint`` marker, or None."""
        marker = os.path.join(self.output_dir, "last_checkpoint")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return f.read().strip()

    def resume_or_load(self, trainer, resume: bool = True) -> int:
        """With ``resume`` and a ``last_checkpoint``, restore ``trainer``
        (``load_state_dict``) from it, on its model's device, and return the
        iteration to start from (the steps it had done); else leave the
        trainer as it is and return 0."""
        if not (resume and self.has_checkpoint()):
            return 0
        name = self.get_last_checkpoint()
        state = self.load(name, map_location=trainer.device)
        trainer.load_state_dict(state)
        logger.info("Resumed from %s at iteration %d", self.path(name), state["iter"])
        return int(state["iter"])


class PeriodicCheckpointer:
    """Saves ``model_{iter:07d}`` after every ``period``-th step and
    ``model_final`` after step ``max_iter - 1``."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_iter: Optional[int] = None):
        self.checkpointer = checkpointer
        self.period = period
        self.max_iter = max_iter

    def step(self, iteration: int, state_fn: Callable[[], Dict[str, Any]]) -> None:
        """``state_fn`` returns the trainer's state; it is called only at a
        save (in a process group it is collective)."""
        it = int(iteration)
        names = []
        if self.period > 0 and (it + 1) % self.period == 0:
            names.append(f"model_{it:07d}")
        if self.max_iter is not None and it + 1 >= self.max_iter:
            names.append("model_final")
        state = state_fn() if names else None
        for name in names:
            self.checkpointer.save(name, state)
