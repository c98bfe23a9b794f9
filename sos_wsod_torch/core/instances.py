"""Fixed-capacity, mask-validated detection container.

Counterpart of ``Detections`` in ``sos_wsod_tpu/core/instances.py``: a plain
dataclass of tensors padded to a static capacity, with a boolean ``valid``
mask marking the real rows.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Detections:
    """Padded per-image detections (post-NMS)."""

    boxes: torch.Tensor    # (D, 4) XYXY
    scores: torch.Tensor   # (D,)
    classes: torch.Tensor  # (D,) int64
    valid: torch.Tensor    # (D,) bool


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    """Per-image (pseudo-)ground truth padded to a static capacity G.

    classes in [0, num_classes); scores and weights carry the pseudo-GT
    confidence; index is the proposal slot each pseudo box came from (used
    to mirror targets across the 4 views); valid masks the real rows."""

    boxes: torch.Tensor    # (G, 4) XYXY
    classes: torch.Tensor  # (G,) int64
    scores: torch.Tensor   # (G,)
    weights: torch.Tensor  # (G,)
    index: torch.Tensor    # (G,) int64
    valid: torch.Tensor    # (G,) bool
