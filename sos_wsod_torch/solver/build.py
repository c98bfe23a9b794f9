"""Optimizer and LR schedules: torch.optim.SGD with detectron2's parameter
groups, and a LambdaLR on the warmup multi-step schedules.

Counterpart of ``sos_wsod_tpu/solver/build.py``, whose ``torch_sgd`` already
follows torch's SGD rule (weight decay added to the gradient before the
momentum, the first buffer equal to the gradient, update lr x buffer):
  - groups: bias lr x BIAS_LR_FACTOR and weight decay WEIGHT_DECAY_BIAS; the
    refinement branches' lr x REFINE_LR_SCALE when REFINE_SCALE_ON; frozen
    backbone stages (``requires_grad`` False) are left out, where the JAX
    package gives them lr 0 and weight decay 0;
  - the schedule multiplies every group's lr and steps once per optimizer
    update, as the JAX package's update count does;
  - CLIP_GRADIENTS clips by value or by global L2 norm before the update
    (under tensor parallelism the norm of the whole model).
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn


def _warmup_factor(it: int, warmup_factor: float, warmup_iters: int, warmup_method: str) -> float:
    if warmup_iters <= 0 or it >= warmup_iters:
        return 1.0
    if warmup_method == "linear":
        alpha = it / warmup_iters
        return warmup_factor * (1 - alpha) + alpha
    return warmup_factor


def warmup_multistep_lr(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                        warmup_factor: float = 1.0 / 1000, warmup_iters: int = 1000,
                        warmup_method: str = "linear") -> Callable[[int], float]:
    """lr(it) = base_lr x warmup(it) x gamma^(#milestones passed)."""
    steps = list(steps)

    def schedule(it: int) -> float:
        wf = _warmup_factor(it, warmup_factor, warmup_iters, warmup_method)
        return base_lr * wf * gamma ** sum(it >= s for s in steps)

    return schedule


def warmup_two_stage_multistep_lr(base_lr: float, steps: Sequence[int],
                                  factor_list: Sequence[float],
                                  warmup_factor: float = 1.0 / 1000, warmup_iters: int = 1000,
                                  warmup_method: str = "linear") -> Callable[[int], float]:
    """lr(it) = base_lr x warmup(it) x factor_list[#milestones passed]."""
    assert len(factor_list) == len(steps) + 1
    steps, factors = list(steps), list(factor_list)

    def schedule(it: int) -> float:
        wf = _warmup_factor(it, warmup_factor, warmup_iters, warmup_method)
        return base_lr * wf * factors[sum(it >= s for s in steps)]

    return schedule


def build_schedule(cfg, base_lr: float) -> Callable[[int], float]:
    """SOLVER.LR_SCHEDULER_NAME's schedule, scaled to ``base_lr``."""
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME == "WarmupTwoStageMultiStepLR":
        return warmup_two_stage_multistep_lr(base_lr, s.STEPS, s.FACTOR_LIST, s.WARMUP_FACTOR,
                                             s.WARMUP_ITERS, s.WARMUP_METHOD)
    return warmup_multistep_lr(base_lr, s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS,
                               s.WARMUP_METHOD)


def d2_param_group_fns(cfg) -> Tuple[Callable[[str], float], Callable[[str], float]]:
    """(lr_scale, weight_decay) of a parameter, by its dotted name: bias lr x
    BIAS_LR_FACTOR and weight decay WEIGHT_DECAY_BIAS, the refinement
    branches' lr x REFINE_LR_SCALE when REFINE_SCALE_ON."""
    refine_scale = cfg.SOLVER.REFINE_LR_SCALE if cfg.SOLVER.REFINE_SCALE_ON else 1.0

    def is_bias(name: str) -> bool:
        return name.rsplit(".", 1)[-1] == "bias"

    def lr_scale(name: str) -> float:
        scale = cfg.SOLVER.BIAS_LR_FACTOR if is_bias(name) else 1.0
        if any(p.startswith("box_refinery") for p in name.split(".")):
            scale *= refine_scale
        return scale

    def weight_decay(name: str) -> float:
        return cfg.SOLVER.WEIGHT_DECAY_BIAS if is_bias(name) else cfg.SOLVER.WEIGHT_DECAY

    return lr_scale, weight_decay


def build_optimizer(cfg, model: nn.Module
                    ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """SGD over the parameters that require grad, one group per parameter
    (lr = BASE_LR x its scale, its weight decay), and a LambdaLR on the
    configured schedule, to be stepped once per ``optimizer.step()``."""
    lr_scale, weight_decay = d2_param_group_fns(cfg)
    base_lr = cfg.SOLVER.BASE_LR
    groups: List[dict] = [
        {"params": [p], "lr": base_lr * lr_scale(name), "weight_decay": weight_decay(name),
         "name": name}
        for name, p in model.named_parameters() if p.requires_grad]
    opt = torch.optim.SGD(groups, lr=base_lr, momentum=cfg.SOLVER.MOMENTUM,
                          nesterov=cfg.SOLVER.NESTEROV)
    factor = build_schedule(cfg, 1.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def clip_gradients(cfg, params, sharded=()) -> None:
    """SOLVER.CLIP_GRADIENTS on the gradients of ``params``, in place.
    ``sharded``: those of ``params`` split over the tensor-parallel group,
    whose squared norms a norm clip sums over the group
    (``parallel/tensor.py:clip_grad_norm_``)."""
    clip = cfg.SOLVER.CLIP_GRADIENTS
    if not clip.ENABLED:
        return
    if clip.CLIP_TYPE == "value":
        torch.nn.utils.clip_grad_value_(params, clip.CLIP_VALUE)
    elif sharded:
        from ..parallel.tensor import clip_grad_norm_

        clip_grad_norm_(params, sharded, clip.CLIP_VALUE)
    else:
        torch.nn.utils.clip_grad_norm_(params, clip.CLIP_VALUE)
