"""Training loop: the hook-driven TrainerBase and the stage-1 trainer.

Counterpart of ``sos_wsod_tpu/engine/trainer.py`` (``TrainerBase``,
``make_stage1_train_step``, ``Stage1Trainer``), eager PyTorch in place of one
jitted step:
  - each image of a batch runs the model's ``loss`` (``MultiInputRCNN`` or
    ``GeneralizedRCNNWSL``) under bf16 autocast
    when TPU.COMPUTE_DTYPE is bfloat16; losses and metrics are averaged over
    the batch, and ``total_loss`` sums the keys starting with "loss";
  - gradients accumulate over WSL.ITER_SIZE steps as their mean (the JAX
    package's optax.MultiSteps), then clipping, SGD and the LR schedule
    step once;
  - a non-finite total raises FloatingPointError before its backward;
  - dropout draws from a torch.Generator seeded with max(SEED, 0) (data
    parallel rank d of a process group: ``comm.derive_seed(max(SEED, 0),
    d)``);
  - ``state_dict``/``load_state_dict`` carry what a resumed run needs:
    model, optimizer, LR schedule, the dropout generator (every rank's),
    ``iter`` (steps completed) and gradients accumulated towards an update.
Each image's backward runs right after its forward, so only one image's
activations are alive at a time.

In a process group (``engine/launch.py``) the model runs under
DistributedDataParallel: each rank takes its share of the global batch
from its loader, every backward but the one that completes an update runs
under ``no_sync``, and DDP's mean over the ranks of the gradients, each the
rank's per-image mean, is the global batch's mean (the losses are per-image
means, so no count crosses the ranks). The logged scalars are means over
the ranks (``comm.reduce_dict``).

Under tensor parallelism (TPU.MODEL_AXIS_SIZE > 1, ``parallel/tensor.py``)
the trainer shards the model's DAN fc stack over the tensor-parallel group
when it is built; DDP then runs over the data-parallel group, every
parameter under it, split or not. The ranks of a tensor-parallel group see
the same images (the loaders shard by data-parallel rank) and draw the same
dropout masks (the generator is seeded by the data-parallel rank), a norm
clip sums the split parameters' squares over the group, and
``state_dict``/``load_state_dict`` speak the one-process layout (gathered
on save, cut on load), so a checkpoint moves between any tensor-parallel
size and one process. Profiler ranges: ``h2d``, ``backward``,
``optimizer`` and those of ``MultiInputRCNN.loss``; ``cpg`` for the CSC and
WSJDS heads' CPG maps, computed before each image's loss.
"""
from __future__ import annotations

import contextlib
import logging
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from ..parallel import comm, tensor
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


def seeded_generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded for this data-parallel rank:
    ``comm.derive_seed(seed, rank)``, ``seed`` itself on rank 0 and in one
    process (the ranks of a tensor-parallel group share theirs)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(comm.derive_seed(seed, tensor.data_rank()))
    return generator


class DataParallelMixin:
    """What the trainers share in a process group: ``model`` is the module
    itself (its ``state_dict``, ``compute_dtype``, evaluation), ``ddp`` its
    DistributedDataParallel wrapper (None in one process); ``run`` calls the
    model through it; the generator's state is saved and restored by
    rank."""

    model: torch.nn.Module
    ddp: Optional[torch.nn.parallel.DistributedDataParallel]
    generator: torch.Generator
    # {name: split dimension} of the parameters split over the
    # tensor-parallel group: none but in Stage1Trainer under tensor parallelism
    tp_dims: Dict[str, int] = {}

    def run(self, fn: Callable[[torch.nn.Module], Any], sync: bool = True):
        """``fn(model)``; in a process group inside DDP's forward, which
        prepares the all-reduce of the next backward unless ``sync`` is
        False (then ``no_sync``: the backward keeps its gradients local,
        and the next synced one reduces them all)."""
        if self.ddp is None:
            return fn(self.model)
        with contextlib.nullcontext() if sync else self.ddp.no_sync():
            return self.ddp(fn)

    def generator_states(self) -> Dict[str, Any]:
        """{"generator": this rank's state}, and in a process group
        "generators": every data-parallel rank's, by that rank (on every
        rank; the ranks of a tensor-parallel group hold the same state)."""
        state = self.generator.get_state()
        out = {"generator": state}
        if comm.get_world_size() > 1:
            out["generators"] = comm.process_gather([state])[::tensor.size()]
            out["generator"] = out["generators"][0]
        return out

    def load_generator_state(self, state: Dict[str, Any]) -> None:
        """This data-parallel rank's generator state of ``state``: its own
        entry of "generators", else (a checkpoint of one process)
        "generator" on data-parallel rank 0; a rank the checkpoint has no
        state for keeps its seed."""
        rank = tensor.data_rank()
        per_rank = state.get("generators")
        if per_rank is not None and rank < len(per_rank):
            self.generator.set_state(per_rank[rank].cpu())
        elif rank == 0:
            self.generator.set_state(state["generator"].cpu())


class Stage1Trainer(DataParallelMixin, TrainerBase):
    """Stage-1 trainer. ``data_iter`` yields a list of mapped samples
    (``data.build.batched_stream``) or one sample; ``model`` is a
    ``MultiInputRCNN`` (4 views an image) or a ``GeneralizedRCNNWSL`` (one),
    and batches go to the device of its parameters. A model whose
    ``uses_iter`` is set (CMIL, CSC, WSJDS) gets the step, ``iter``, as the
    loss's ``cur_iter``, as the JAX step injects it; a resumed run goes on
    from the checkpoint's. A model whose ``uses_cpgs`` is set (CSC, WSJDS)
    gets each image's CPG maps as the loss's ``cpgs`` (``_cpgs``)."""

    def __init__(self, cfg, model, data_iter):
        super().__init__()
        self.cfg = cfg
        self.model = model.train()
        self.tp_dims = tensor.shard_model(model)
        self.ddp = comm.wrap_ddp(model, tensor.data_group())
        self.data_iter = data_iter
        self.device = next(model.parameters()).device
        self.optimizer, self.scheduler = build_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self._sharded = [p for g in self.optimizer.param_groups if g["name"] in self.tp_dims
                         for p in g["params"]]
        self.iter_size = max(1, int(cfg.WSL.ITER_SIZE or 1))
        self.generator = seeded_generator(self.device, max(cfg.SEED, 0))
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
        updates = (self._micro_steps + 1) % self.iter_size == 0
        per_image = []
        kwargs = {"cur_iter": self.iter} if getattr(self.model, "uses_iter", False) else {}
        for i, sample in enumerate(samples):
            with record_function("h2d"):
                b = {k: torch.as_tensor(v, device=self.device)
                     for k, v in sample.items() if k != "image_id"}
            # only the backward that completes an update all-reduces
            sync = updates and i == n - 1
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bf16):
                if getattr(self.model, "uses_cpgs", False):
                    kwargs["cpgs"] = self._cpgs(b)
                losses = self.run(lambda m: m.loss(b, self.generator, **kwargs), sync)
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
                clip_gradients(self.cfg, self.params, self._sharded)
                self.optimizer.step()
                self.scheduler.step()
                self.optimizer.zero_grad(set_to_none=True)

        keys = list(per_image[0])
        means = {k: torch.stack([m[k] for m in per_image]).mean() for k in keys}
        means = comm.reduce_dict(means)
        self.storage.put_scalar("data_time", data_time)
        for k, v in zip(keys, torch.stack([means[k] for k in keys]).tolist()):
            self.storage.put_scalar(k, v)
        self.steps_done = self.iter + 1

    def _cpgs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The CSC or WSJDS head's CPG maps of one image, from the module
        itself (outside DDP's forward, so that its reducer never sees their
        backward), with the dropout masks the loss's forward then draws
        again: the generator's state is restored after them, as the JAX
        step hands both forwards one dropout key."""
        state = self.generator.get_state()
        with record_function("cpg"):
            cpgs = self.model.compute_cpgs(batch, self.generator)
        self.generator.set_state(state)
        return cpgs

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs; ``iter`` is the number of steps done.
        Gradients accumulated towards the next update (WSL.ITER_SIZE > 1)
        are kept too; in a process group each rank's, which are its own
        until the update's all-reduce ("rank_grads", by rank). Model,
        momenta and gradients are in the one-process layout. Collective in
        a process group: every rank calls it."""
        pending = self._micro_steps % self.iter_size
        grads = [self._gather(name, p.grad) for name, p in self._named_params()] \
            if pending else None
        acc = {"micro_steps": pending, "grads": grads}
        if pending and comm.get_world_size() > 1:
            acc["rank_grads"] = comm.process_gather([[g.cpu() for g in grads]])
        optimizer = self._map_momenta(self.optimizer.state_dict(), self._gather)
        return {"model": tensor.gather_state_dict(self.model.state_dict(), self.tp_dims),
                "optimizer": optimizer, "scheduler": self.scheduler.state_dict(),
                **self.generator_states(), "iter": self.steps_done, "accumulated": acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` (tensors on the model's device), with
        this rank's generator state and accumulated gradients, each split
        tensor cut to this rank's shard."""
        self.model.load_state_dict(tensor.shard_state_dict(state["model"], self.tp_dims))
        self.optimizer.load_state_dict(self._map_momenta(state["optimizer"], self._cut))
        self.scheduler.load_state_dict(state["scheduler"])
        self.load_generator_state(state)
        self.steps_done = int(state["iter"])
        acc = state["accumulated"]
        self._micro_steps = acc["micro_steps"]
        grads = acc["grads"]
        rank_grads = acc.get("rank_grads")
        if rank_grads is not None and comm.get_rank() < len(rank_grads):
            grads = rank_grads[comm.get_rank()]
        for (name, p), g in zip(self._named_params(), grads or [None] * len(self.params)):
            p.grad = None if g is None else self._cut(name, g.to(self.device))

    def _map_momenta(self, optimizer: Dict[str, Any], fn) -> Dict[str, Any]:
        """A copy of an SGD ``state_dict`` with ``fn(name, buffer)`` applied
        to the momentum buffers of the split parameters (the optimizer's
        own state is left alone)."""
        if not self.tp_dims:
            return optimizer
        states = dict(optimizer["state"])
        for group in optimizer["param_groups"]:
            for i in group["params"]:
                buf = states.get(i)
                if group["name"] in self.tp_dims and buf and \
                        buf.get("momentum_buffer") is not None:
                    states[i] = {**buf, "momentum_buffer": fn(group["name"],
                                                               buf["momentum_buffer"])}
        return {**optimizer, "state": states}

    def _named_params(self):
        """(name, parameter) in the optimizer's order."""
        return [(g["name"], p) for g in self.optimizer.param_groups for p in g["params"]]

    def _gather(self, name: str, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``t`` (a parameter's shard, or a tensor shaped like it) in the
        one-process layout."""
        if t is None or name not in self.tp_dims:
            return t
        return tensor.gather_state_dict({name: t}, self.tp_dims)[name]

    def _cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A one-process tensor of parameter ``name`` cut to this rank's
        shard."""
        if name not in self.tp_dims:
            return t
        return tensor.shard(t, self.tp_dims[name], tensor.rank(), tensor.size()).clone()
