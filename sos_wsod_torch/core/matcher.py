"""Proposal <-> ground-truth matcher over fixed-capacity, masked ground truth.

Counterpart of ``sos_wsod_tpu/core/matcher.py`` (detectron2's ``Matcher``).
Invalid gt rows take quality -1, so they never win the argmax; with no valid
gt every prediction has quality -1 and falls in the lowest band, which is
torch's "no gt => labels[0]" branch for the configs in use. Ties go to the
first gt row, like ``torch.max`` in d2.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


class Matcher:
    def __init__(self, thresholds: Sequence[float], labels: Sequence[int],
                 allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        assert thresholds[0] > 0
        assert len(labels) == len(thresholds) + 1
        assert all(label in (-1, 0, 1) for label in labels)
        self.thresholds = [-float("inf")] + thresholds + [float("inf")]
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, match_quality_matrix: torch.Tensor,
                 gt_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """match_quality_matrix (M, N) IoU of M gt rows against N
        predictions; gt_valid (M,) bool. Returns (matches (N,) int64, the best
        gt row of each prediction, 0 without valid gt; match_labels (N,) int8
        in {-1, 0, 1} by the threshold bands)."""
        q = torch.where(gt_valid[:, None], match_quality_matrix,
                        torch.full_like(match_quality_matrix, -1.0))
        matched_vals = q.max(dim=0).values
        matches = torch.argmax(q, dim=0)   # the first maximum on ties
        match_labels = torch.ones(matches.shape, dtype=torch.int8, device=q.device)
        for label, low, high in zip(self.labels, self.thresholds[:-1], self.thresholds[1:]):
            in_band = (matched_vals >= low) & (matched_vals < high)
            match_labels = torch.where(in_band, torch.full_like(match_labels, label),
                                       match_labels)
        if self.allow_low_quality_matches:
            # d2's set_low_quality_matches_ has no quality > 0 guard: a gt
            # whose best IoU is 0 marks every zero-IoU prediction as label 1
            highest = torch.where(gt_valid, match_quality_matrix.max(dim=1).values,
                                  torch.full_like(gt_valid, -1.0, dtype=q.dtype))
            is_best = (match_quality_matrix == highest[:, None]) & gt_valid[:, None]
            match_labels = torch.where(is_best.any(dim=0), torch.ones_like(match_labels),
                                       match_labels)
        return matches, match_labels
