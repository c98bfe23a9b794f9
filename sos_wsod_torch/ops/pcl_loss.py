"""PCL (Proposal Cluster Learning) loss with the reference kernel's gradient.

Counterpart of ``sos_wsod_tpu/ops/pcl_loss.py`` (the reference's pcl_loss
kernel). Per channel, over R proposals with probabilities ``probs`` (R, C),
channel 0 the background:

  out[0] = -sum_{i: labels_i = 0} w_i * log(max(probs[i, 0], 1e-6))
  out[c] = -sum_{j: pc_labels_j = c} imgw_j * log(max(pc_probs_j, 1e-6))   c > 0
  out[c] = 0 where im_labels[c] == 0

The gradient is the kernel's rule, not the forward's derivative (eps 1e-5):

  g[i, 0] = -w_i / max(probs[i, 0], eps)                        labels_i == 0
  g[i, c] = -imgw_a / max(pc_count_a * pc_probs_a, eps)         labels_i == c > 0,
                                                                a = gt_assignment_i

so every member of a cluster gets the cluster-mean probability's gradient;
channels with im_labels 0 get none, and each channel is multiplied by its
incoming cotangent, as the JAX package does (the reference kernel ignores
it; its callers sum, where the two agree). Only ``probs`` gets a gradient.
Plain tensor code: the JAX package computes it as XLA ops, not a kernel.
"""
from __future__ import annotations

import torch

EPS_FORWARD = 1e-6
EPS_BACKWARD = 1e-5


def _forward(probs, labels, cls_loss_weights, pc_labels, pc_probs, img_cls_loss_weights,
             im_labels):
    c = probs.shape[1]
    bg = torch.where(labels == 0,
                     -cls_loss_weights * torch.log(probs[:, 0].clamp(min=EPS_FORWARD)), 0.0)
    fg = -img_cls_loss_weights * torch.log(pc_probs.clamp(min=EPS_FORWARD))
    out = torch.zeros(c, dtype=probs.dtype, device=probs.device)
    out = out.index_add(0, pc_labels.long(), fg.to(probs.dtype))
    out[0] = bg.sum()
    return torch.where(im_labels != 0, out, 0.0)


class PCLLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, labels, cls_loss_weights, gt_assignment, pc_labels, pc_probs,
                pc_count, img_cls_loss_weights, im_labels):
        ctx.save_for_backward(probs, labels, cls_loss_weights, gt_assignment, pc_probs,
                              pc_count, img_cls_loss_weights, im_labels)
        return _forward(probs, labels, cls_loss_weights, pc_labels, pc_probs,
                        img_cls_loss_weights, im_labels)

    @staticmethod
    def backward(ctx, ct):
        (probs, labels, cls_loss_weights, gt_assignment, pc_probs, pc_count,
         img_cls_loss_weights, im_labels) = ctx.saved_tensors
        lab = labels.long()
        a = gt_assignment.long()
        ch = torch.arange(probs.shape[1], device=probs.device)[None, :]
        g0 = -cls_loss_weights / probs[:, 0].clamp(min=EPS_BACKWARD)
        gfg = -img_cls_loss_weights[a] / (pc_count[a] * pc_probs[a]).clamp(min=EPS_BACKWARD)
        grad = torch.where((ch == 0) & (lab[:, None] == 0), g0[:, None],
                           torch.where((ch > 0) & (lab[:, None] == ch), gfg[:, None], 0.0))
        grad = torch.where(im_labels[None, :] != 0, grad, 0.0) * ct[None, :]
        return (grad.to(probs.dtype),) + (None,) * 8


def pcl_loss(probs: torch.Tensor, labels: torch.Tensor, cls_loss_weights: torch.Tensor,
             gt_assignment: torch.Tensor, pc_labels: torch.Tensor, pc_probs: torch.Tensor,
             pc_count: torch.Tensor, img_cls_loss_weights: torch.Tensor,
             im_labels: torch.Tensor) -> torch.Tensor:
    """probs (R, C) softmax, background at channel 0; labels (R,) cluster
    class (0 = background); cls_loss_weights (R,); gt_assignment (R,) index
    into the (G,) cluster arrays pc_labels, pc_probs, pc_count and
    img_cls_loss_weights; im_labels (C,) with the background's slot.
    Returns the (C,) per-channel loss."""
    return PCLLoss.apply(probs, labels, cls_loss_weights, gt_assignment, pc_labels, pc_probs,
                         pc_count, img_cls_loss_weights, im_labels)
