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
