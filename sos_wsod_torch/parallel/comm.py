"""Rank, world and the few collectives the port's data parallelism needs.

Counterpart of ``sos_wsod_tpu/parallel/mesh.py`` (and of detectron2's
``utils/comm.py``): one process per GPU under ``torch.distributed`` in place
of one JAX mesh over the chips. What the mesh module does and what stands in
for it here:
  - ``shard_batch``: the loaders keep every world-th index of one seeded
    stream from the process's rank on (``data/build.py``,
    ``data/mapper_twocrop.py``), so each process maps its own share of the
    global batch;
  - ``replicate``: ``DistributedDataParallel`` broadcasts rank 0's
    parameters and buffers when it wraps the model (``wrap_ddp``), and its
    gradient all-reduce keeps the replicas equal from there on;
  - ``make_mesh``'s model axis is ``parallel/tensor.py``'s process groups;
    ``data_sharding`` and ``replicated`` have no counterpart: there is no
    mesh, each process holds its tensors on its own device;
  - ``local_batch_size`` and ``process_gather`` are ported as they are.
Outside a process group every function here answers for one process: rank
0 of 1, gathers are the identity, ``synchronize`` does nothing.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# set by engine/launch.py in each process it starts; torchrun sets LOCAL_RANK
_LOCAL_RANK: Optional[int] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    """This process's rank among the processes of its machine."""
    if not is_initialized():
        return 0
    if _LOCAL_RANK is not None:
        return _LOCAL_RANK
    return int(os.environ.get("LOCAL_RANK", 0))


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier across the processes; nothing in one process."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == dist.Backend.NCCL:
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def local_device(name: str) -> torch.device:
    """The torch device of MODEL.DEVICE ``name`` in this process: "cuda"
    is the card the launcher gave this rank (the current device); any other
    name as it is."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_batch_size(global_batch: int, world: Optional[int] = None) -> int:
    """Each process's share of ``global_batch``; raises unless it divides."""
    world = get_world_size() if world is None else world
    if global_batch % world:
        raise ValueError(f"batch {global_batch} is not divisible by {world} processes")
    return global_batch // world


def process_gather(objs: list) -> list:
    """Every process's list ``objs``, concatenated in rank order, on every
    process (picklable items); the list itself in one process."""
    world = get_world_size()
    if world == 1:
        return objs
    out: List[Optional[list]] = [None] * world
    dist.all_gather_object(out, objs)
    return [x for part in out for x in part]


def reduce_dict(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the processes of each scalar of ``values`` (one
    all-reduce of them stacked, in f32); the dict itself in one process.
    Every process must pass the same keys in the same order."""
    world = get_world_size()
    if world == 1 or not values:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= world
    return dict(zip(keys, stacked))


def derive_seed(seed: int, index: int) -> int:
    """The seed of stream ``index`` of ``seed``: ``seed`` itself for index 0
    (so rank 0, or the first image, draws what a single process drew), else
    a 63-bit seed from numpy's SeedSequence of (seed, index)."""
    if index == 0:
        return seed
    state = np.random.SeedSequence((seed, index)).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def wrap_ddp(model: torch.nn.Module, process_group=None
             ) -> Optional[torch.nn.parallel.DistributedDataParallel]:
    """``model`` under DistributedDataParallel (its own card's device id on
    CUDA) over ``process_group`` (the whole world when None; the
    data-parallel group under tensor parallelism), through ``CallModule``
    so that any of its methods runs through DDP's forward; None outside a
    process group."""
    if not is_initialized():
        return None
    device = next(model.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        CallModule(model), device_ids=[device.index] if device.type == "cuda" else None,
        process_group=process_group)


class CallModule(torch.nn.Module):
    """``forward(fn)`` returns ``fn(module)``. DistributedDataParallel
    prepares its gradient all-reduce only in its ``forward``, and the
    trainers' losses are methods of the model (``loss``, ``losses``, two
    calls of a semi-supervised step), so each step's calls run inside one
    ``forward`` of this module."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, fn):
        return fn(self.module)
