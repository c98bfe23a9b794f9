"""PCL (Proposal Cluster Learning) ROI head and its host clustering.

Counterpart of ``sos_wsod_tpu/models/heads/pcl.py`` (the reference's
PCLROIHeads and third_party/pcl.py): DAN + WSDDN MIL + K refinement branches,
each trained by the PCL loss (``ops/pcl_loss.py``) over proposal clusters
built on the host:
  - per present class, the top-ranking proposals: members of the
    highest-center cluster of a k-means(3) of the class's probabilities
    (``ops/kmeans.py``, scikit-learn's algorithm, random_state 3, 10 starts);
  - graph centers: greedily the proposal of highest IoU > 0.4 degree among
    them, its neighbours removed, until at most 5 remain; the 5 best-scoring
    centers of the class (centers chosen leave the pool of later classes);
  - every proposal joins its highest-IoU center (foreground at IoU >= 0.5,
    background below, weight 0 below 0.1), and each cluster's mean
    probability of its class feeds the loss.
The targets are padded to fixed shapes: R proposals and 5 x num_classes
clusters. The branch logits put the background at column 0; ``predict``
rolls it to the last column. On the card each branch copies boxes, the
previous scores and its probabilities to the host once and its targets back
once.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ...ops.kmeans import kmeans_1d
from ...ops.pcl_loss import pcl_loss
from .dan import DAN
from .oicr import OICRBranch
from .wsddn import WSDDNHead, mil_loss, wsddn_scores

NUM_KMEANS_CLUSTER = 3
RNG_SEED = 3
GRAPH_IOU_THRESHOLD = 0.4
MAX_PC_NUM = 5
FG_THRESH = 0.5
BG_THRESH = 0.1
_EPS = 1e-9


def pairwise_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def top_ranking_proposals(probs: np.ndarray) -> np.ndarray:
    """Indices of the members of the highest-center cluster of a
    k-means(min(3, n)) of the 1-D ``probs``."""
    labels, centers = kmeans_1d(probs, min(NUM_KMEANS_CLUSTER, probs.shape[0]), RNG_SEED)
    index = np.where(labels == np.argmax(centers))[0]
    if len(index) == 0:
        index = np.array([np.argmax(probs)])
    return index


def get_graph_centers(boxes: np.ndarray, cls_prob: np.ndarray, im_labels: np.ndarray):
    """Greedy graph-center cluster seeds of the present classes. Returns
    (gt_boxes (G, 4), gt_classes (G,) 1-based, gt_scores (G,))."""
    num_classes = im_labels.shape[0]
    boxes = boxes.copy()
    cls_prob = cls_prob.copy()
    gt_boxes = np.zeros((0, 4), np.float32)
    gt_classes = np.zeros((0,), np.int32)
    gt_scores = np.zeros((0,), np.float32)
    for i in range(num_classes):
        if im_labels[i] != 1:
            continue
        cls_prob_tmp = cls_prob[:, i].copy()
        idxs = np.where(cls_prob_tmp >= 0)[0]
        idxs = idxs[top_ranking_proposals(cls_prob_tmp[idxs])]
        boxes_tmp = boxes[idxs, :].copy()
        cls_prob_tmp = cls_prob_tmp[idxs]
        graph = pairwise_iou_np(boxes_tmp, boxes_tmp) > GRAPH_IOU_THRESHOLD

        keep_idxs = []
        scores_tmp = []
        count = cls_prob_tmp.size
        # each row's degree as f32, kept up to date as rows and columns are
        # cut: counts are exact in f32, so argsort sees the values (and the
        # dtype) of the reference's np.sum(graph, axis=1) of an f32 graph,
        # without its O(n^2) pass a center
        degree = graph.sum(axis=1, dtype=np.float32)
        while True:
            order = degree.argsort()[::-1]
            tmp = order[0]
            keep_idxs.append(tmp)
            inds = np.where(graph[tmp, :])[0]
            scores_tmp.append(np.max(cls_prob_tmp[inds]) if len(inds) else cls_prob_tmp[tmp])
            degree -= graph[:, inds].sum(axis=1, dtype=np.float32)
            degree[inds] = 0
            graph[:, inds] = False
            graph[inds, :] = False
            count = count - len(inds)
            if count <= 5:
                break

        keep_idxs = np.array(keep_idxs)
        scores_tmp = np.array(scores_tmp, np.float32)
        keep_new = np.argsort(scores_tmp)[-1:(-1 - min(len(scores_tmp), MAX_PC_NUM)):-1]
        gt_boxes = np.vstack((gt_boxes, boxes_tmp[keep_new, :]))
        gt_scores = np.concatenate((gt_scores, scores_tmp[keep_new]))
        gt_classes = np.concatenate((gt_classes, np.full(len(keep_new), i + 1, np.int32)))
        # the chosen centers leave the pool of the later classes
        delete = idxs[keep_idxs][keep_new]
        cls_prob = np.delete(cls_prob, delete, axis=0)
        boxes = np.delete(boxes, delete, axis=0)
    return gt_boxes, gt_classes, gt_scores


def get_proposal_clusters(all_rois: np.ndarray, gt_boxes: np.ndarray, gt_classes: np.ndarray,
                          gt_scores: np.ndarray, cls_prob_new: np.ndarray):
    """Every proposal to its highest-IoU center; per-cluster weights, mean
    probabilities and sizes."""
    overlaps = pairwise_iou_np(all_rois, gt_boxes)
    gt_assignment = overlaps.argmax(axis=1)
    max_overlaps = overlaps.max(axis=1)
    labels = gt_classes[gt_assignment].astype(np.int32)
    cls_loss_weights = gt_scores[gt_assignment].astype(np.float32)

    bg_inds = max_overlaps < FG_THRESH
    ig_inds = max_overlaps < BG_THRESH
    cls_loss_weights[ig_inds] = 0.0
    labels[bg_inds] = 0
    gt_assignment = np.where(bg_inds, -1, gt_assignment)

    g = gt_boxes.shape[0]
    img_cls_loss_weights = np.zeros(g, np.float32)
    pc_probs = np.zeros(g, np.float32)
    pc_count = np.zeros(g, np.float32)
    for i in range(g):
        po = np.where(gt_assignment == i)[0]
        img_cls_loss_weights[i] = np.sum(cls_loss_weights[po])
        pc_count[i] = len(po)
        if len(po):
            pc_probs[i] = np.average(cls_prob_new[po, gt_classes[i]])
    return (labels, cls_loss_weights, gt_assignment.astype(np.int32),
            gt_classes.astype(np.int32), pc_probs, pc_count, img_cls_loss_weights)


def pcl_targets_np(boxes: np.ndarray, cls_prob: np.ndarray, im_labels: np.ndarray,
                   cls_prob_new: np.ndarray, valid: np.ndarray, max_pc: int):
    """The PCL targets of one branch, padded to R proposals and ``max_pc``
    clusters. ``cls_prob`` is (R, C) (the MIL scores) or (R, C+1) with the
    background at column 0 (a branch's probabilities); ``cls_prob_new`` is
    (R, C+1) background-first. Valid proposals are the first ones. Returns
    (labels, cls_loss_weights, gt_assignment (R,), pc_labels, pc_probs,
    pc_count, img_cls_loss_weights (max_pc,), im_labels_real (C+1,))."""
    r = boxes.shape[0]
    c = im_labels.shape[0]
    nvalid = int(valid.sum())
    out = {
        "labels": np.zeros(r, np.int32),
        "cls_loss_weights": np.zeros(r, np.float32),
        "gt_assignment": np.zeros(r, np.int32),
        "pc_labels": np.zeros(max_pc, np.int32),
        "pc_probs": np.zeros(max_pc, np.float32),
        "pc_count": np.zeros(max_pc, np.float32),
        "img_cls_loss_weights": np.zeros(max_pc, np.float32),
        "im_labels_real": np.concatenate(([1.0], im_labels.astype(np.float32))),
    }
    if nvalid == 0 or im_labels.sum() == 0:
        return tuple(out.values())

    boxes_v = np.asarray(boxes[:nvalid], np.float32)
    cls_prob_v = np.asarray(cls_prob[:nvalid], np.float32)
    if cls_prob_v.shape[1] != c:
        cls_prob_v = cls_prob_v[:, 1:]
    new_v = np.clip(np.asarray(cls_prob_new[:nvalid], np.float32), _EPS, 1 - _EPS)
    cls_prob_v = np.clip(cls_prob_v, _EPS, 1 - _EPS)

    gt_boxes, gt_classes, gt_scores = get_graph_centers(boxes_v, cls_prob_v, im_labels)
    if gt_boxes.shape[0] == 0:
        return tuple(out.values())
    labels, w, assign, pc_labels, pc_probs, pc_count, img_w = get_proposal_clusters(
        boxes_v, gt_boxes, gt_classes, gt_scores, new_v)

    g = min(len(pc_labels), max_pc)
    out["labels"][:nvalid] = labels
    out["cls_loss_weights"][:nvalid] = w
    out["gt_assignment"][:nvalid] = np.clip(assign, 0, max(max_pc - 1, 0))
    out["pc_labels"][:g] = pc_labels[:g]
    out["pc_probs"][:g] = pc_probs[:g]
    out["pc_count"][:g] = pc_count[:g]
    out["img_cls_loss_weights"][:g] = img_w[:g]
    return tuple(out.values())


class PCLROIHead(nn.Module):
    """DAN + WSDDN MIL + K PCL refinement branches (background at column 0)."""

    def __init__(self, in_features: int, num_classes: int = 20, refine_k: int = 3,
                 mean_loss: bool = True, dan_dims: Sequence[int] = (4096, 4096),
                 dan_dropout: float = 0.5, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.refine_k = refine_k
        self.mean_loss = mean_loss
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)
        for k in range(refine_k):
            self.add_module(f"box_refinery_{k}", OICRBranch(dan_dims[-1], num_classes,
                                                             has_reg=False, device=device))

    @property
    def refine(self):
        return [getattr(self, f"box_refinery_{k}") for k in range(self.refine_k)]

    def _branch_loss(self, logits, boxes, prop_valid, prev, gt_classes_oh
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One branch's PCL loss: the host clustering, then ``pcl_loss``."""
        probs = torch.softmax(logits.float(), dim=-1)
        with record_function("mining"):
            host = torch.cat([boxes.float(), prev, probs.detach(), prop_valid.float()[:, None]],
                             dim=1).cpu().numpy()
            b, pv = host[:, :4], host[:, -1] > 0
            prev_np = host[:, 4:4 + prev.shape[1]]
            probs_np = host[:, 4 + prev.shape[1]:-1]
            targets = pcl_targets_np(b, prev_np, gt_classes_oh.float().cpu().numpy(), probs_np,
                                     pv, MAX_PC_NUM * self.num_classes)
            targets = [torch.from_numpy(t) for t in targets]
            packed = torch.cat([t.float() for t in targets]).to(logits.device)
            targets = list(torch.split(packed, [t.numel() for t in targets]))
        labels, w, assign, pc_labels, pc_probs, pc_count, img_w, im_labels = targets
        per_channel = pcl_loss(probs, labels.long(), w, assign.long(), pc_labels.long(),
                               pc_probs, pc_count, img_w, im_labels)
        return per_channel.sum(), probs

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """pooled (P, PH, PW, C) objectness-weighted; boxes (P, 4); prop_valid
        (P,); gt_classes_oh (K,). Returns loss_cls and loss_cls_r{k}."""
        with record_function("box_head"):
            feats = self.dan(pooled, generator)
            c, d = self.wsddn(feats)
        scores = wsddn_scores(c, d, prop_valid)
        losses = {"loss_cls": mil_loss(scores, gt_classes_oh, self.mean_loss)}
        prev = scores.detach()                       # (P, K) for branch 0
        for k, branch in enumerate(self.refine):
            with record_function("box_head"):
                logits, _ = branch(feats)
            losses[f"loss_cls_r{k}"], probs = self._branch_loss(
                logits, boxes, prop_valid, prev, gt_classes_oh)
            prev = probs.detach()                    # (P, K+1) background first
        return losses

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean of the K branch softmaxes with the background moved from
        column 0 to the last; the boxes are the proposals for every class."""
        feats = self.dan(pooled)
        probs = None
        for branch in self.refine:
            pk = torch.softmax(branch(feats)[0].float(), dim=-1)
            probs = pk if probs is None else probs + pk
        probs = probs / self.refine_k
        probs = torch.cat([probs[:, 1:], probs[:, :1]], dim=1)
        return probs, boxes.float().repeat(1, self.num_classes)
