"""The port's optimizer and schedules (sos_wsod_torch/solver/build.py:
torch.optim.SGD with d2's parameter groups and a LambdaLR) against the JAX
package's build_optimizer (torch-semantics SGD in optax) over 3 updates from
the same gradients: bias lr x 2 and weight decay 0, frozen stages, the
refinement LR scale, value and norm clipping, both schedules.

Tolerance: the same f32 element-wise updates; the schedule is evaluated in
f64 in the port and f32 in JAX, and torch's norm clip divides by
norm + 1e-6 where optax divides by the norm: rtol 1e-5, atol 1e-7.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from sos_wsod_tpu.config import get_cfg as jax_get_cfg
from sos_wsod_tpu.solver.build import build_optimizer as jax_build_optimizer
from sos_wsod_tpu.solver.build import warmup_multistep_lr as jax_warmup_multistep_lr
from sos_wsod_tpu.solver.build import (
    warmup_two_stage_multistep_lr as jax_warmup_two_stage_multistep_lr,
)
from sos_wsod_torch.config import get_cfg
from sos_wsod_torch.solver.build import (
    build_optimizer,
    clip_gradients,
    warmup_multistep_lr,
    warmup_two_stage_multistep_lr,
)

# parameter names as the stage-1 model has them: a frozen stage, a trained
# stage, the box head and a refinement branch
NAMES = ("backbone.plain1.conv1", "backbone.plain3.conv1", "roi_heads.dan.fc1",
         "roi_heads.box_refinery_0.cls_score")


def _model(rng):
    root = nn.Module()
    for name in NAMES:
        node = root
        for part in name.split(".")[:-1]:
            if not hasattr(node, part):
                node.add_module(part, nn.Module())
            node = getattr(node, part)
        layer = nn.Linear(5, 3)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(rng.randn(3, 5).astype(np.float32)))
            layer.bias.copy_(torch.from_numpy(rng.randn(3).astype(np.float32)))
        node.add_module(name.split(".")[-1], layer)
    root.backbone.plain1.requires_grad_(False)
    return root


def _tree(named):
    """{dotted name: array} -> the nested flax tree the JAX solver reads."""
    tree = {}
    for name, a in named.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if leaf == "weight" else "bias"] = jnp.asarray(a)
    return tree


def _leaf(tree, name):
    *path, leaf = name.split(".")
    for p in path:
        tree = tree[p]
    return tree["kernel" if leaf == "weight" else "bias"]


@pytest.mark.parametrize("schedule", ["WarmupMultiStepLR", "WarmupTwoStageMultiStepLR"])
@pytest.mark.parametrize("clip", [None, "value", "norm"])
def test_sgd_matches_jax_over_three_updates(schedule, clip):
    opts = ["SOLVER.BASE_LR", 0.1, "SOLVER.MOMENTUM", 0.9, "SOLVER.WEIGHT_DECAY", 0.01,
            "SOLVER.BIAS_LR_FACTOR", 2.0, "SOLVER.WEIGHT_DECAY_BIAS", 0.0,
            "SOLVER.REFINE_SCALE_ON", True, "SOLVER.REFINE_LR_SCALE", 3.0,
            "SOLVER.LR_SCHEDULER_NAME", schedule, "SOLVER.STEPS", (1, 2),
            "SOLVER.FACTOR_LIST", (1.0, 0.5, 0.25), "SOLVER.GAMMA", 0.5,
            "SOLVER.WARMUP_ITERS", 2, "SOLVER.WARMUP_FACTOR", 0.1,
            "MODEL.BACKBONE.FREEZE_AT", 2]
    if clip:
        opts += ["SOLVER.CLIP_GRADIENTS.ENABLED", True, "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", clip,
                 "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.5 if clip == "value" else 1.0]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(list(opts))
    jcfg.merge_from_list(list(opts))

    rng = np.random.RandomState(0)
    model = _model(rng)
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt, sched = build_optimizer(cfg, model)
    assert {g["name"] for g in opt.param_groups} == {n for n in start if "plain1" not in n}
    tx = jax_build_optimizer(jcfg)
    params = _tree(start)
    state = tx.init(params)
    for _ in range(3):
        # a frozen stage's JAX gradient is 0 (stop_gradient), so it adds
        # nothing to the global norm
        grads = {n: (rng.randn(*a.shape) * 2 * ("plain1" not in n)).astype(np.float32)
                 for n, a in start.items()}
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[name])
        clip_gradients(cfg, [p for g in opt.param_groups for p in g["params"]])
        opt.step()
        sched.step()
        updates, state = tx.update(_tree(grads), state, params)
        params = optax.apply_updates(params, updates)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(_leaf(params, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        assert np.array_equal(p.detach().numpy(), start[name]) == ("plain1" in name), name


def test_schedules_match_jax():
    for it in range(0, 12):
        assert warmup_multistep_lr(0.02, (4, 8), 0.1, 0.001, 5)(it) == pytest.approx(
            float(jax_warmup_multistep_lr(0.02, (4, 8), 0.1, 0.001, 5)(it)), rel=1e-6)
        assert warmup_two_stage_multistep_lr(0.02, (6,), (1.0, 0.3), 0.01, 3, "constant")(
            it) == pytest.approx(float(jax_warmup_two_stage_multistep_lr(
                0.02, (6,), (1.0, 0.3), 0.01, 3, "constant")(it)), rel=1e-6)
