"""Random weights from a seed, made on the device in a few large calls.

A configuration's ``init`` lists rules ``[pattern, kind, value]``; the first
whose regular expression matches a parameter's name decides it:
``normal`` (std ``value``), ``msra`` (std sqrt(2 / (k * k * out channels)),
the convs' He init), ``const`` (every entry ``value``), ``uniform`` (in
[value[0], value[1]]). All normal and uniform entries come from one draw
each of a generator seeded by the run's seed, in sorted name order, so the
same seed and device give the same weights to the system and to the
reference.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence

import torch


def _rule(name: str, rules: Sequence[Sequence]) -> Sequence:
    for rule in rules:
        if re.search(rule[0], name):
            return rule
    raise KeyError(f"no init rule matches {name}")


def make(shapes: Dict[str, tuple], rules: List[Sequence], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every name of ``shapes``."""
    names = sorted(shapes)
    kinds = {n: _rule(n, rules) for n in names}
    numel = {n: math.prod(shapes[n]) for n in names}
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    normal = torch.randn(sum(numel[n] for n in names if kinds[n][1] in ("normal", "msra")),
                         generator=g, device=device)
    uniform = torch.rand(sum(numel[n] for n in names if kinds[n][1] == "uniform"),
                         generator=g, device=device)
    out, at_n, at_u = {}, 0, 0
    for n in names:
        _, kind, *value = kinds[n]
        shape, size = shapes[n], numel[n]
        if kind == "const":
            out[n] = torch.full(shape, float(value[0]), device=device)
        elif kind == "uniform":
            lo, hi = value[0]
            out[n] = (uniform[at_u:at_u + size] * (hi - lo) + lo).reshape(shape)
            at_u += size
        else:
            std = value[0] if kind == "normal" else math.sqrt(2.0 / (shape[2] * shape[3] * shape[0]))
            out[n] = (normal[at_n:at_n + size] * std).reshape(shape)
            at_n += size
    return out
