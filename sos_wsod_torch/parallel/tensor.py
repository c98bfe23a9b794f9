"""Tensor parallelism of the DAN fc stack (Megatron's MLP split).

Counterpart of ``sos_wsod_tpu/parallel/sharding_rules.py`` (``DAN_TP_RULES``,
``spec_for``), of ``parallel/mesh.py:make_mesh`` with a model axis, and of the
state placement in ``engine/trainer.py``'s ``init_state``. Where the JAX
package lays a (data, model) mesh over the chips and lets GSPMD insert the
collectives, here the world of ``--num-gpus`` x ``--num-machines`` processes
is split into process groups and the two collectives are explicit:

  - ``init(tp)``: world W = dp x tp, the model axis varying fastest: rank r
    is in the tensor-parallel group of ranks ``r - r % tp ...
    r - r % tp + tp - 1`` and in the data-parallel group of ranks
    ``{r % tp + k * tp}``. W not divisible by tp raises, as ``make_mesh``
    does; a world of one runs without tensor parallelism, as the JAX CLI
    builds no mesh on one chip;
  - the rules (``DAN_TP_RULES``), by name suffix: fc1's weight (torch's
    (out, in) layout) and bias split by rows (column-parallel in Megatron's
    terms), fc2's weight by columns (row-parallel); fc2's bias stays whole
    and is added once, after the reduction. A DAN whose fc1 width does not
    divide by tp, or that has no fc2, stays replicated (``spec_for``'s
    fallback);
  - ``copy_to_tensor_parallel`` (the identity forward, its backward
    all-reduces fc1's input gradient over the group) and
    ``reduce_from_tensor_parallel`` (all-reduces fc2's partial output, the
    identity backward): the conjugate autograd Functions the DAN calls
    (``models/heads/dan.py``), so that DistributedDataParallel's reducer,
    which runs over the data-parallel group, never sees them;
  - ``shard_model`` replaces the split parameters of a built model with this
    rank's slices and hands each DAN the group; ``shard_state_dict`` and
    ``gather_state_dict`` convert between the one-process layout (every
    checkpoint's) and a rank's shard.
Outside ``init`` (or after ``init(1)``) the data-parallel rank and size are
the process's rank and the world's.
"""
from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from . import comm

# (regex on the dotted parameter name, the dimension split over the group)
DAN_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(^|\.)dan\.fc1\.weight$", 0),
    (r"(^|\.)dan\.fc1\.bias$", 0),
    (r"(^|\.)dan\.fc2\.weight$", 1),
)

_STATE: Optional[Dict[str, object]] = None


def init(tp: int) -> None:
    """Split the process group into tensor-parallel groups of ``tp`` ranks
    and data-parallel groups across them (collective: every rank calls it
    with the same ``tp``). ``tp`` 1, or a world of one, clears any earlier
    split."""
    global _STATE
    _STATE = None
    world = comm.get_world_size()
    if tp <= 1 or world == 1:
        return
    if world % tp:
        raise ValueError(f"{world} processes not divisible by MODEL_AXIS_SIZE={tp}")
    rank = comm.get_rank()
    tp_groups = [dist.new_group(list(range(s, s + tp))) for s in range(0, world, tp)]
    dp_groups = [dist.new_group(list(range(t, world, tp))) for t in range(tp)]
    _STATE = {"tp": tp, "rank": rank % tp, "group": tp_groups[rank // tp],
              "dp": world // tp, "dp_rank": rank // tp, "dp_group": dp_groups[rank % tp]}


def size() -> int:
    """The tensor-parallel group's size (1 without tensor parallelism)."""
    return _STATE["tp"] if _STATE else 1


def rank() -> int:
    """This process's rank in its tensor-parallel group."""
    return _STATE["rank"] if _STATE else 0


def group():
    """This process's tensor-parallel group (None without one)."""
    return _STATE["group"] if _STATE else None


def data_group():
    """This process's data-parallel group (None: the whole world)."""
    return _STATE["dp_group"] if _STATE else None


def data_rank() -> int:
    """This process's rank among the data-parallel replicas: the ranks of
    one tensor-parallel group share it, see the same images and draw the
    same dropout masks."""
    return _STATE["dp_rank"] if _STATE else comm.get_rank()


def data_world_size() -> int:
    return _STATE["dp"] if _STATE else comm.get_world_size()


def spec_for(name: str, shape: Sequence[int], tp: int,
             rules: Sequence[Tuple[str, int]] = DAN_TP_RULES) -> Optional[int]:
    """The dimension of parameter ``name`` that the rules split over ``tp``
    ranks, or None (replicated): no rule matches, or the dimension does not
    divide by ``tp``."""
    if tp <= 1:
        return None
    for pattern, dim in rules:
        if re.search(pattern, name) and dim < len(shape):
            return dim if shape[dim] % tp == 0 else None
    return None


def split_dims(shapes: Mapping[str, Sequence[int]], tp: int) -> Dict[str, int]:
    """{name: split dimension} of the entries of ``shapes`` (a state dict's
    names and shapes) that tensor parallelism splits: a DAN's fc1 weight,
    fc1 bias and fc2 weight together when all three split, else none of
    them."""
    out: Dict[str, int] = {}
    for name, shape in shapes.items():
        if not re.search(DAN_TP_RULES[0][0], name):
            continue
        prefix = name[:-len("fc1.weight")]
        names = [prefix + "fc1.weight", prefix + "fc1.bias", prefix + "fc2.weight"]
        dims = [spec_for(n, shapes[n], tp) if n in shapes else None for n in names]
        if all(d is not None for d in dims):
            out.update(zip(names, dims))
    return out


def shard(t: torch.Tensor, dim: int, r: int, tp: int) -> torch.Tensor:
    """Rank ``r``'s contiguous 1/``tp`` of ``t`` along ``dim``."""
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n)


def shard_state_dict(sd: Mapping[str, torch.Tensor], dims: Mapping[str, int],
                     r: Optional[int] = None, tp: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """A one-process state dict with the entries of ``dims`` cut to rank
    ``r``'s shard (this process's by default); the others as they are."""
    r = rank() if r is None else r
    tp = size() if tp is None else tp
    return {k: shard(v, dims[k], r, tp).clone() if k in dims else v for k, v in sd.items()}


def _all_gather_cat(t: torch.Tensor, dim: int, grp) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``, in group rank
    order, on ``t``'s device (gloo gathers CUDA tensors through the host)."""
    device = t.device
    if dist.get_backend(grp) == dist.Backend.GLOO:
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, t.contiguous(), group=grp)
    return torch.cat(parts, dim).to(device)


def gather_state_dict(sd: Mapping[str, torch.Tensor], dims: Mapping[str, int]
                      ) -> Dict[str, torch.Tensor]:
    """A rank's state dict in the one-process layout: the entries of
    ``dims`` gathered over the tensor-parallel group (collective), the
    others as they are."""
    return {k: _all_gather_cat(v, dims[k], group()) if k in dims else v for k, v in sd.items()}


def shard_model(model: nn.Module) -> Dict[str, int]:
    """Replace the parameters that the rules split with this rank's slices
    (new leaf parameters, ``requires_grad`` kept) and give every DAN whose
    fc stack is split the tensor-parallel group. Returns the split
    dimensions by parameter name ({} without tensor parallelism)."""
    from ..models.heads.dan import DAN

    tp, r = size(), rank()
    dims = split_dims({n: p.shape for n, p in model.named_parameters()}, tp)
    for name, dim in dims.items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(shard(p.detach(), dim, r, tp).clone(),
                                           requires_grad=p.requires_grad))
    for name, module in model.named_modules():
        if isinstance(module, DAN) and f"{name}.fc1.weight" in dims:
            module.fc1.out_features //= tp
            module.fc2.in_features //= tp
            module.tp_group, module.tp_rank, module.tp_size = group(), r, tp
    return dims


# while ``traced()`` is open: one record per all-reduce of the two Functions
_TRACE: Optional[List[Dict[str, object]]] = None


@contextlib.contextmanager
def traced():
    """Within the block, every all-reduce of the DAN's two Functions is
    timed alone (the device synchronized before and after it) and recorded
    as {"op", "shape", "dtype", "bytes", "ms"} in the yielded list."""
    global _TRACE
    _TRACE = []
    try:
        yield _TRACE
    finally:
        _TRACE = None


def _all_reduce(t: torch.Tensor, grp, op: str) -> None:
    if _TRACE is None:
        dist.all_reduce(t, group=grp)
        return
    sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    dist.all_reduce(t, group=grp)
    sync()
    _TRACE.append({"op": op, "shape": tuple(t.shape), "dtype": str(t.dtype).split(".")[-1],
                   "bytes": t.numel() * t.element_size(),
                   "ms": (time.perf_counter() - t0) * 1e3})


class _CopyToTensorParallel(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.grp, "fc1 input gradient (backward)")
        return g, None


class _ReduceFromTensorParallel(torch.autograd.Function):
    """The sum over the group of each rank's partial output; the backward
    is the identity."""

    @staticmethod
    def forward(ctx, x, grp):
        out = x.contiguous().clone()
        _all_reduce(out, grp, "fc2 partial output (forward)")
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_parallel(x: torch.Tensor, grp) -> torch.Tensor:
    return _CopyToTensorParallel.apply(x, grp)


def reduce_from_tensor_parallel(x: torch.Tensor, grp) -> torch.Tensor:
    return _ReduceFromTensorParallel.apply(x, grp)


def clip_grad_norm_(params: Sequence[nn.Parameter], sharded: Sequence[nn.Parameter],
                    max_norm: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` (L2) over the whole model: the
    squared norms of the ``sharded`` parameters' gradients are summed over
    the tensor-parallel group first, the replicated ones counted once.
    Returns the total norm."""
    sharded_ids = {id(p) for p in sharded}
    grads = [(p.grad, id(p) in sharded_ids) for p in params if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    device = grads[0][0].device
    sq = [torch.zeros((), dtype=torch.float32, device=device) for _ in range(2)]
    for g, is_sharded in grads:
        sq[is_sharded] += torch.linalg.vector_norm(g.float()) ** 2
    dist.all_reduce(sq[1], group=group())
    total = (sq[0] + sq[1]).sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g, _ in grads:
        g.mul_(coef.to(g.dtype))
    return total
