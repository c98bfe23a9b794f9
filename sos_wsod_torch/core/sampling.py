"""Balanced positive/negative subsampling as fixed-shape masked ops.

Counterpart of ``sos_wsod_tpu/core/sampling.py`` (detectron2's
``subsample_labels``): up to ``num_samples * positive_fraction`` positives
at random, the rest of ``num_samples`` random negatives. Each candidate gets
a random priority and is ranked within its class by a stable sort; it is
kept when its rank is below the class's budget, so nothing leaves the
device and no shape depends on the data.

Every uniform draw of the port's training path goes through ``uniform``
(one torch.Generator, in call order), and every random permutation through
``permutation``, so a test can stand JAX's draws in for them: the two
frameworks give different numbers from the same seed.
"""
from __future__ import annotations

from typing import Tuple

import torch


def uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` on ``device``, from ``generator``."""
    return torch.rand(shape, generator=generator, device=device)


def permutation(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """A random permutation of range(n), int64 on ``device``, from
    ``generator``."""
    return torch.randperm(n, generator=generator, device=device)


def _rank_among(mask: torch.Tensor, priority: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True element of ``mask`` among the masked
    elements by descending priority (ties: the lower index first); False
    elements get rank n."""
    n = mask.shape[0]
    key = torch.where(mask, priority, torch.full_like(priority, float("-inf")))
    order = torch.sort(-key, stable=True).indices
    ranks = torch.empty(n, dtype=torch.int64, device=mask.device)
    ranks[order] = torch.arange(n, device=mask.device)
    return torch.where(mask, ranks, torch.full_like(ranks, n))


def subsample_masks(pos_mask: torch.Tensor, neg_mask: torch.Tensor, num_samples: int,
                    positive_fraction: float, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_keep, neg_keep) bool masks with |pos_keep| = min(num_samples *
    positive_fraction, #pos) and |neg_keep| = min(num_samples - |pos_keep|,
    #neg). Draws the positives' priorities, then the negatives'."""
    pri_pos = uniform(pos_mask.shape, generator, pos_mask.device)
    pri_neg = uniform(neg_mask.shape, generator, neg_mask.device)
    pos_budget = torch.clamp(pos_mask.sum(), max=int(num_samples * positive_fraction))
    pos_keep = pos_mask & (_rank_among(pos_mask, pri_pos) < pos_budget)
    neg_budget = torch.minimum(num_samples - pos_budget, neg_mask.sum())
    neg_keep = neg_mask & (_rank_among(neg_mask, pri_neg) < neg_budget)
    return pos_keep, neg_keep


def subsample_labels(labels: torch.Tensor, num_samples: int, positive_fraction: float,
                     generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """``subsample_masks`` with label 1 positive and 0 negative (-1 ignored)."""
    return subsample_masks(labels == 1, labels == 0, num_samples, positive_fraction, generator)
