"""OICR refinement branch: per-branch classifier + box regressor, and losses.

Counterpart of ``sos_wsod_tpu/models/heads/oicr.py``: cls_score Linear(F,
K+1), bbox_pred Linear(F, K*4); a branch without regression returns zero
deltas. Losses, in f32, over R = the true proposal count:
  cls = sum of CE(logits, gt class; -1 ignored) * pseudo-GT weight / R
  reg = sum over foreground of smooth_l1(deltas[gt class] - target deltas) / R
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...core.boxes import get_deltas


class OICRBranch(nn.Module):
    def __init__(self, in_features: int, num_classes: int, has_reg: bool = True,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = nn.Linear(in_features, num_classes + 1, device=device)
        self.bbox_pred = (nn.Linear(in_features, num_classes * 4, device=device)
                          if has_reg else None)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (P, F) -> (scores (P, K+1), deltas (P, K*4))."""
        scores = self.cls_score(x)
        if self.bbox_pred is None:
            return scores, scores.new_zeros((x.shape[0], self.num_classes * 4))
        return scores, self.bbox_pred(x)


def weighted_ce_loss(logits: torch.Tensor, gt_classes: torch.Tensor, weights: torch.Tensor,
                     prop_valid: torch.Tensor) -> torch.Tensor:
    """Ignore-aware weighted CE, mean over the true proposal count.
    logits (P, K+1); gt_classes (P,) int with -1 = ignore; weights (P,)."""
    logits = logits.float()
    active = prop_valid & (gt_classes >= 0)
    safe_cls = gt_classes.clamp(0, logits.shape[1] - 1).long()
    logz = torch.logsumexp(logits, dim=1)
    ce = logz - torch.gather(logits, 1, safe_cls[:, None])[:, 0]
    ce = torch.where(active, ce * weights, 0.0)
    return ce.sum() / prop_valid.float().sum().clamp(min=1.0)


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    if beta <= 1e-5:
        return x.abs()
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def box_reg_loss(deltas: torch.Tensor, proposal_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_classes: torch.Tensor, prop_valid: torch.Tensor, *, num_classes: int,
                 beta: float = 0.0, weights=(10.0, 10.0, 5.0, 5.0),
                 loss_type: str = "smooth_l1",
                 sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Foreground-only smooth-L1 over the gt class's delta columns, sum / R.
    loss_type 'smooth_l1_weighted' scales each row by ``sample_weights``;
    'smooth_l1_mean' divides by the foreground count instead of R."""
    p = deltas.shape[0]
    fg = prop_valid & (gt_classes >= 0) & (gt_classes < num_classes)
    safe_cls = gt_classes.clamp(0, num_classes - 1).long()
    d = deltas.reshape(p, num_classes, 4)
    d_fg = torch.gather(d, 1, safe_cls[:, None, None].expand(p, 1, 4))[:, 0]
    gt_d = get_deltas(proposal_boxes, gt_boxes, weights)
    per = smooth_l1(d_fg.float() - gt_d, beta).sum(dim=1)
    if loss_type == "smooth_l1_weighted":
        if sample_weights is None:
            raise ValueError("box_reg_loss: 'smooth_l1_weighted' needs sample_weights")
        per = per * sample_weights
    per = torch.where(fg, per, 0.0)
    denom = fg if loss_type == "smooth_l1_mean" else prop_valid
    return per.sum() / denom.float().sum().clamp(min=1.0)
