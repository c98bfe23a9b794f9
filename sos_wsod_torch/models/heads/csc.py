"""The CSC ROI head: WSDDN MIL with constraints from the CPG maps.

Counterpart of ``sos_wsod_tpu/models/heads/csc.py`` (the reference's
CSCROIHeads):
  - ``compute_cpg``: the class peak gradient maps, for each class
    |d sum_p scores[p, c] / d image| maxed over the colour channels and
    normalised to a peak of 1 (floored at 1e-12); zero unless the class is
    present and its image score is at least tau. The JAX package pulls all
    classes back at once under vmap and masks the inactive ones; here one
    ``torch.autograd.grad`` runs for each active class, and the inactive
    ones are exact zeros, which gives the same maps;
  - ``csc_mil_loss``: a BCE on sum(scores * W_pos) against PL and one on
    sum(scores * W_neg) against NL;
  - ``CSCROIHead``: DAN + WSDDN; its loss takes W from the CSC op
    (``ops/csc.py``) on the CPG maps; past WSL.CSC_MAX_ITER (``use_csc``
    False) W_pos = 1 and W_neg = 0, the plain MIL loss; prediction is the
    MIL scores with a zero background column, on the proposals.
``pooled`` is the channels-last (P, PH, PW, C) pooled ROIs, already weighted
by objectness + 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...ops.csc import csc
from .dan import DAN
from .wsddn import WSDDNHead, mil_image_scores, wsddn_scores


def compute_cpg(scores: torch.Tensor, image: torch.Tensor, gt_classes_oh: torch.Tensor,
                preds_img: torch.Tensor, tau: float = 0.7, channel_dim: int = -1
                ) -> torch.Tensor:
    """scores (P, K), computed from ``image`` (which requires grad; (H, W,
    3) with ``channel_dim`` -1) -> (K, H, W) f32 CPG maps, detached. The
    graph of ``scores`` is freed after the last active class."""
    k = scores.shape[1]
    active = (gt_classes_oh >= 0.5) & (preds_img >= tau)
    shape = list(image.shape)
    del shape[channel_dim]
    cpgs = torch.zeros([k, *shape], dtype=torch.float32, device=image.device)
    classes = active.nonzero().flatten().tolist()
    for i, c in enumerate(classes):
        (grad,) = torch.autograd.grad(scores[:, c].sum(), image,
                                      retain_graph=i < len(classes) - 1)
        cpg = grad.abs().amax(dim=channel_dim).float()
        cpgs[c] = cpg / cpg.amax().clamp(min=1e-12)
    return cpgs


def csc_mil_loss(scores: torch.Tensor, w_pos: torch.Tensor, w_neg: torch.Tensor,
                 pl: torch.Tensor, nl: torch.Tensor, mean_loss: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """The reference's CSCOutputs.csc_loss: BCE of the W-weighted image
    scores, clamped to [1e-20, 1 - 1e-20], against PL and NL."""
    def bce(p, t):
        terms = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
        return terms.mean() if mean_loss else terms.sum()

    img_pos = (scores * w_pos).sum(dim=0).clamp(1e-20, 1.0 - 1e-20)
    img_neg = (scores * w_neg).sum(dim=0).clamp(1e-20, 1.0 - 1e-20)
    return {"loss_cls_pos": bce(img_pos, pl), "loss_cls_neg": bce(img_neg, nl)}


class CSCROIHead(nn.Module):
    """DAN + WSDDN with the CSC positive and negative constraints."""

    fg_threshold = 0.1
    context_scale = 1.8
    area_sqrt = True

    def __init__(self, in_features: int, num_classes: int = 20, mean_loss: bool = True,
                 dan_dims: Sequence[int] = (4096, 4096), dan_dropout: float = 0.5, device=None):
        super().__init__()
        self.mean_loss = mean_loss
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)

    def scores(self, pooled: torch.Tensor, prop_valid: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(P, K) f32 MIL proposal scores; padded rows are zero."""
        with record_function("box_head"):
            c, d = self.wsddn(self.dan(pooled, generator))
        return wsddn_scores(c, d, prop_valid)

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor, cpgs: torch.Tensor, use_csc: bool,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """cpgs (K, H, W) from ``compute_cpg``, in the image coordinates of
        ``boxes``; ``use_csc`` is False past WSL.CSC_MAX_ITER."""
        scores = self.scores(pooled, prop_valid, generator)
        return self._csc_losses(scores, cpgs, boxes, prop_valid, gt_classes_oh, use_csc)

    def _csc_losses(self, scores: torch.Tensor, cpgs: torch.Tensor, boxes: torch.Tensor,
                    prop_valid: torch.Tensor, gt_classes_oh: torch.Tensor, use_csc: bool,
                    prefix: str = "", loss_weight: float = 1.0) -> Dict[str, torch.Tensor]:
        """``csc_mil_loss`` with W from the CSC op on ``cpgs`` (W_pos = 1,
        W_neg = 0 unless ``use_csc``), its keys prefixed and its terms
        scaled by ``loss_weight``."""
        valid = prop_valid[:, None]
        if use_csc:
            with record_function("csc"):
                w, pl, nl = csc(cpgs, gt_classes_oh, mil_image_scores(scores.detach()), boxes,
                                prop_valid, fg_threshold=self.fg_threshold,
                                area_sqrt=self.area_sqrt, context_scale=self.context_scale)
            w_pos = torch.where(valid, w.clamp(min=0.0), 0.0)
            w_neg = torch.where(valid, w.clamp(max=0.0).abs(), 0.0)
        else:
            pl = gt_classes_oh.float()
            nl = torch.zeros_like(pl)
            w_pos = valid.expand_as(scores).float()
            w_neg = torch.zeros_like(scores)
        losses = csc_mil_loss(scores, w_pos, w_neg, pl, nl, self.mean_loss)
        return {prefix + k: v * loss_weight for k, v in losses.items()}

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores (P, K+1) with a zero background column, the proposals
        (P, 4))."""
        scores = self.scores(pooled, prop_valid)
        return torch.cat([scores, scores.new_zeros((scores.shape[0], 1))], dim=1), boxes.float()
