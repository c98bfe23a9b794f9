"""DiscriminativeAdaptionNeck (DAN) box head.

Counterpart of ``sos_wsod_tpu/models/heads/dan.py`` for the OICR+ config (no
convs): flatten the channels-last pooled ROIs in (h, w, c) order, then
FC -> ReLU -> Dropout per entry of ``fc_dims``. fc1's input rows are in
(h, w, c) order; ``engine.weights`` permutes torch/caffe (c, h, w) weights
to match. Dropout runs in training mode only, with its masks drawn from the
``generator`` the caller passes (the trainer's seeded one), else from
PyTorch's default generator.

Under tensor parallelism (``parallel/tensor.py:shard_model`` sets
``tp_group``) this rank holds rows of fc1 and the matching columns of fc2:
the input's gradient is summed over the group in the backward, fc2's
partial products are summed in the forward and its bias added once after.
Dropout after fc1 draws the full (rows, fc1 width) mask from the generator
and keeps this rank's columns, so that the generator stays in step with the
one-process step and the masks equal its own bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F


class DAN(nn.Module):
    def __init__(self, in_features: int, fc_dims: Sequence[int] = (4096, 4096),
                 dropout_rate: float = 0.5, device=None):
        super().__init__()
        dims = [in_features, *fc_dims]
        for i in range(len(fc_dims)):
            self.add_module(f"fc{i + 1}", nn.Linear(dims[i], dims[i + 1], device=device))
        self.num_fc = len(fc_dims)
        self.dropout_rate = dropout_rate
        self.tp_group, self.tp_rank, self.tp_size = None, 0, 1

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (P, PH, PW, C) -> (P, fc_dims[-1])."""
        x = x.reshape(x.shape[0], -1)
        first = 0
        if self.tp_group is not None:
            x, first = self._split_fc12(x, generator), 2
        for i in range(first, self.num_fc):
            x = dropout(F.relu(getattr(self, f"fc{i + 1}")(x)), self.dropout_rate, self.training,
                        generator)
        return x

    def _split_fc12(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """fc1 and fc2 with their ReLUs and dropouts on this rank's shards."""
        from ...parallel.tensor import copy_to_tensor_parallel, reduce_from_tensor_parallel

        h = F.relu(self.fc1(copy_to_tensor_parallel(x, self.tp_group)))
        h = dropout(h, self.dropout_rate, self.training, generator,
                    columns=(self.tp_rank * h.shape[1], h.shape[1] * self.tp_size))
        y = reduce_from_tensor_parallel(F.linear(h, self.fc2.weight), self.tp_group)
        y = y + self.fc2.bias.to(y.dtype)
        return dropout(F.relu(y), self.dropout_rate, self.training, generator)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout in training mode, its keep mask drawn from
    ``generator`` (PyTorch's default generator when None). ``columns``
    (start, full width): ``x`` holds those columns of a wider tensor, whose
    whole mask is drawn and sliced."""
    if not training or rate == 0.0:
        return x
    if columns is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        start, width = columns
        full = torch.rand((x.shape[0], width), generator=generator, device=x.device)
        keep = full[:, start:start + x.shape[1]] >= rate
    return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))
