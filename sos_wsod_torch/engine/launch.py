"""Start a function in one process per GPU, in one process group.

Counterpart of ``sos_wsod_tpu/engine/defaults.py:maybe_init_distributed``
and of the reference's ``detectron2/engine/launch.py``:
  - a world of one (``--num-gpus 1 --num-machines 1``, and no torchrun
    environment) calls ``main_func`` in this process with no process group:
    a single-process run is the same program as before data parallelism;
  - otherwise ``torch.multiprocessing`` spawns ``num_gpus_per_machine``
    processes on this machine; each joins the group at ``dist_url`` as rank
    ``machine_rank * num_gpus_per_machine + local_rank``, takes its card
    (``torch.cuda.set_device``), waits at a barrier and calls
    ``main_func(*args)``;
  - under torchrun (RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR in the
    environment, the counterpart of the JAX package's JAX_COORDINATOR_ADDRESS)
    this process joins the group from the environment and calls
    ``main_func`` itself.
The backend is NCCL for ``device`` "cuda" and gloo for "cpu"; ``backend``
overrides it. Nothing falls back: more ranks on a machine than it has cards
raise before any process starts (unless ``backend`` is "gloo", whose ranks
may share a card: rank r takes card r mod the count), and a group that
fails to form raises.
"""
from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..parallel import comm

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device: str, backend: Optional[str]) -> str:
    return backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")


def _torchrun_world() -> int:
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")):
        return int(os.environ["WORLD_SIZE"])
    return 1


def _join(backend: str, device: str, local_rank: int, init_method: str, world_size: int,
          rank: int, timeout: datetime.timedelta) -> None:
    """Take this rank's card, join the group and wait for the others."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=timeout)
    comm._LOCAL_RANK = local_rank
    comm.synchronize()


def _worker(local_rank: int, main_func: Callable, world_size: int, num_gpus_per_machine: int,
            machine_rank: int, dist_url: str, args: tuple, backend: str, device: str,
            timeout: datetime.timedelta) -> None:
    _join(backend, device, local_rank, dist_url, world_size,
          machine_rank * num_gpus_per_machine + local_rank, timeout)
    try:
        main_func(*args)
    finally:
        dist.destroy_process_group()


def spawn(main_func: Callable, nprocs: int, *, world_size: Optional[int] = None,
          machine_rank: int = 0, dist_url: str = "auto", args: Sequence = (),
          backend: Optional[str] = None, device: str = "cuda",
          timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Spawn ``nprocs`` processes of one group (``world_size``, default
    ``nprocs``) that each run ``main_func(*args)``; returns when all have
    ended and raises if one failed. Unlike ``launch``, a world of one still
    runs in a process of its own, in a group of one."""
    world_size = world_size or nprocs
    if dist_url == "auto":
        dist_url = f"tcp://127.0.0.1:{_free_port()}"
    mp.start_processes(_worker, nprocs=nprocs, start_method="spawn",
                       args=(main_func, world_size, nprocs, machine_rank, dist_url, tuple(args),
                             _backend(device, backend), device, timeout))


def launch(main_func: Callable, num_gpus_per_machine: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto", args: Sequence = (),
           backend: Optional[str] = None, device: str = "cuda",
           timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """Run ``main_func(*args)`` on ``num_gpus_per_machine`` x
    ``num_machines`` processes (see the module's docstring). Returns what
    ``main_func`` returns in a world of one, else None."""
    world_size = num_gpus_per_machine * num_machines
    env_world = _torchrun_world()
    if env_world > 1 and not comm.is_initialized():
        if world_size not in (1, env_world):
            raise ValueError(f"--num-gpus x --num-machines = {world_size} but torchrun's "
                             f"WORLD_SIZE is {env_world}")
        _join(_backend(device, backend), device, int(os.environ["LOCAL_RANK"]), "env://",
              env_world, int(os.environ["RANK"]), timeout)
        try:
            return main_func(*args)
        finally:
            dist.destroy_process_group()
    if world_size <= 1:
        return main_func(*args)
    if num_machines > 1 and not dist_url.startswith("tcp://"):
        raise ValueError(f"--num-machines {num_machines} needs --dist-url tcp://host:port "
                         f"(the address of machine 0), not {dist_url!r}")
    if not 0 <= machine_rank < num_machines:
        raise ValueError(f"--machine-rank {machine_rank} of {num_machines} machines")
    if torch.device(device).type == "cuda" and backend != "gloo":
        have = torch.cuda.device_count()
        if num_gpus_per_machine > have:
            raise RuntimeError(f"--num-gpus {num_gpus_per_machine} but this machine has {have} "
                               f"CUDA device(s); NCCL takes one card a process")
    logger.info("Launching %d processes on this machine (rank %d of %d machines, world %d, "
                "%s)", num_gpus_per_machine, machine_rank, num_machines, world_size,
                _backend(device, backend))
    spawn(main_func, num_gpus_per_machine, world_size=world_size, machine_rank=machine_rank,
          dist_url=dist_url, args=args, backend=backend, device=device, timeout=timeout)
    return None
