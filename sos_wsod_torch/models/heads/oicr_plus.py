"""OICR+ head: DAN + WSDDN + K OICR branches, over 4 synchronized views.

Counterpart of ``sos_wsod_tpu/models/heads/oicr_plus.py``: pseudo-GT mining
(``mist_mining``, ``top_k_mining``, ``mist_mining_wetectron``), IoU labelling
(``label_and_sample``), the 4-view training losses (``OICRPlusHead.losses``)
and branch-ensembled inference (``predict``). The pooled features arrive
channels-last with the objectness weighting already applied by the pooler
(``row_scale``). Every collection keeps the JAX package's fixed capacity and
validity mask.

Rankings use a stable descending ``torch.sort``: ``jax.lax.top_k`` puts the
lower index first on ties and ``torch.topk`` promises no order. Reference
quirk kept on purpose: view 3's branch losses use view 2's predictions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...core.boxes import apply_deltas, pairwise_iou
from ...core.instances import GroundTruth
from ...core.matcher import Matcher
from ...ops.nms import nms_mask
from .dan import DAN
from .oicr import OICRBranch, box_reg_loss, weighted_ce_loss
from .wsddn import WSDDNHead, mil_loss, wsddn_scores


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last dim: the k largest, lower index first on ties."""
    vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def _ranked_candidates(prev_scores, prop_valid, k, mist_p):
    """Per-class ranking of the valid proposals by score: (vals, idxs) of
    shape (K, kmax), the rank grid and the per-class seed budget
    max(int(n_valid * mist_p), 1)."""
    p = prop_valid.shape[0]
    kmax = min(int(p * mist_p) + 1, p)
    top_k_count = (prop_valid.sum().float() * mist_p).to(torch.int64).clamp(min=1)
    masked = torch.where(prop_valid[:, None], prev_scores[:, :k].float(), float("-inf"))
    vals, idxs = _top_k(masked.T, kmax)
    rank = torch.arange(kmax, device=prev_scores.device)
    return vals, idxs, rank, top_k_count


def _compact(seed_valid, vals, rank, seed_cap):
    """Indices of at most ``seed_cap`` flattened seeds, valid first by score;
    rank-0 seeds get a bonus so the always-kept top-1 per class survives."""
    flat_vals = vals.reshape(-1)
    bonus = torch.where(rank == 0, 1e4, 0.0).expand_as(vals).reshape(-1)
    sel = torch.where(seed_valid.reshape(-1), flat_vals + bonus, float("-inf"))
    return _top_k(sel, min(seed_cap, flat_vals.shape[0]))[1]


def mist_mining(prev_scores: torch.Tensor, prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                gt_classes_oh: torch.Tensor, *, mist_p: float = 0.10, mist_thre: float = 0.05,
                nms_thresh: float = 0.01, seed_cap: int = 1024) -> GroundTruth:
    """MIST pseudo-GT mining, "nms" type. Per present class: the top
    max(int(n_valid * mist_p), 1) proposals by score, the top-1 always, lower
    ranks only with score >= mist_thre; the seeds of all classes then pass
    one class-agnostic NMS at IoU ``nms_thresh``. prev_scores (P, K) or
    (P, K+1); only the first K columns are read. Capacity ``seed_cap``."""
    k = gt_classes_oh.shape[0]
    vals, idxs, rank, top_k_count = _ranked_candidates(prev_scores, prop_valid, k, mist_p)
    seed_valid = (gt_classes_oh.bool()[:, None] & (rank < top_k_count)
                  & ((rank == 0) | (vals >= mist_thre)) & torch.isfinite(vals))
    take = _compact(seed_valid, vals, rank, seed_cap)
    s_scores = vals.reshape(-1)[take]
    s_idx = idxs.reshape(-1)[take]
    s_cls = torch.arange(k, device=vals.device).repeat_interleave(vals.shape[1])[take]
    s_valid = seed_valid.reshape(-1)[take]
    s_boxes = prop_boxes[s_idx]
    keep = nms_mask(s_boxes, s_scores, s_valid, nms_thresh)
    return GroundTruth(boxes=s_boxes, classes=s_cls, scores=s_scores, weights=s_scores,
                       index=s_idx, valid=keep & s_valid)


def top_k_mining(prev_scores: torch.Tensor, prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                 gt_classes_oh: torch.Tensor) -> GroundTruth:
    """Mining for ``WSL.REFINE_MIST: False``: the highest-scoring proposal
    of each present class (the first on ties), weight = score, no NMS.
    Capacity K, one slot per class."""
    k = gt_classes_oh.shape[0]
    masked = torch.where(prop_valid[:, None], prev_scores[:, :k].float(), float("-inf"))
    vals = masked.max(dim=0).values
    idxs = torch.argmax(masked, dim=0)
    valid = gt_classes_oh.bool() & torch.isfinite(vals)
    safe = torch.where(valid, vals, 0.0)
    return GroundTruth(boxes=prop_boxes[idxs], classes=torch.arange(k, device=idxs.device),
                       scores=safe, weights=safe, index=idxs, valid=valid)


def mist_mining_wetectron(prev_scores: torch.Tensor, prop_boxes: torch.Tensor,
                          prop_valid: torch.Tensor, gt_classes_oh: torch.Tensor, *,
                          mist_p: float = 0.10, mist_thre: float = 0.05, iou_thre: float = 0.2,
                          seed_cap: int = 1024) -> GroundTruth:
    """"wetectron"-type MIST, as the JAX package defines it: per present
    class, rank the top max(int(n_valid * mist_p), 1) proposals; rank 0 is
    kept, rank i survives iff its IoU with every higher-ranked candidate of
    its class (kept or not) is < ``iou_thre`` and its score >= mist_thre. No
    cross-class NMS."""
    k = gt_classes_oh.shape[0]
    vals, idxs, rank, top_k_count = _ranked_candidates(prev_scores, prop_valid, k, mist_p)
    cand = gt_classes_oh.bool()[:, None] & (rank[None, :] < top_k_count) & torch.isfinite(vals)
    boxes_k = prop_boxes[idxs]                               # (K, kmax, 4)
    iou = pairwise_iou(boxes_k, boxes_k)                     # (K, kmax, kmax)
    prev_mask = rank[None, :] < rank[:, None]                # [i, j]: j ranks above i
    max_prev = torch.where(prev_mask[None] & cand[:, None, :], iou, 0.0).max(dim=-1).values
    keep = ((max_prev < iou_thre) & (vals >= mist_thre)) | (rank[None, :] == 0)
    seed_valid = cand & keep
    take = _compact(seed_valid, vals, rank, seed_cap)
    s_valid = seed_valid.reshape(-1)[take]
    s_scores = torch.where(s_valid, vals.reshape(-1)[take], 0.0)
    classes = torch.arange(k, device=vals.device).repeat_interleave(vals.shape[1])
    return GroundTruth(boxes=boxes_k.reshape(-1, 4)[take], classes=classes[take],
                       scores=s_scores, weights=s_scores, index=idxs.reshape(-1)[take],
                       valid=s_valid)


def label_and_sample(gt: GroundTruth, prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                     matcher: Matcher, num_classes: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Give every proposal a class (num_classes = background, -1 = ignore), a
    weight and its pseudo-GT's proposal index; no subsampling. Returns
    (gt_classes (P,), weights (P,), index (P,), fg_mask (P,))."""
    matched, labels = matcher(pairwise_iou(gt.boxes, prop_boxes), gt.valid)
    cls = torch.where(labels == 1, gt.classes[matched],
                      torch.where(labels == 0, num_classes, -1))
    weights = torch.where(cls == -1, 0.0, gt.weights[matched])
    weights = torch.where(gt.valid.any(), weights, 0.0)
    fg = prop_valid & (cls >= 0) & (cls < num_classes)
    return cls, weights, gt.index[matched], fg


class OICRPlusHead(nn.Module):
    bbox_reg_weights = (10.0, 10.0, 5.0, 5.0)
    smooth_l1_beta = 0.0

    def __init__(self, in_features: int, num_classes: int = 20, refine_k: int = 4,
                 refine_reg: Sequence[bool] = (True, True, True, True),
                 refine_mist: bool = True, mist_type: str = "nms", mist_p: float = 0.10,
                 mist_thre: float = 0.05, bbox_update: bool = False, mean_loss: bool = True,
                 seed_cap: int = 1024, dan_dims: Sequence[int] = (4096, 4096),
                 dan_dropout: float = 0.5, device=None):
        super().__init__()
        if refine_mist and mist_type not in ("nms", "wetectron"):
            raise ValueError(f"WSL.MIST_TYPE must be 'nms' or 'wetectron', got {mist_type!r}")
        self.num_classes = num_classes
        self.refine_k = refine_k
        self.refine_reg = tuple(refine_reg)
        self.refine_mist = refine_mist
        self.mist_type = mist_type
        self.mist_p = mist_p
        self.mist_thre = mist_thre
        self.bbox_update = bbox_update
        self.mean_loss = mean_loss
        self.seed_cap = seed_cap
        self.matcher = Matcher([0.5, 0.6], [0, -1, 1])
        self.dan = DAN(in_features, dan_dims, dan_dropout, device=device)
        self.wsddn = WSDDNHead(dan_dims[-1], num_classes, device=device)
        for k in range(refine_k):
            self.add_module(f"box_refinery_{k}", OICRBranch(
                dan_dims[-1], num_classes, has_reg=refine_reg[k], device=device))

    @property
    def refine(self) -> List[OICRBranch]:
        return [getattr(self, f"box_refinery_{k}") for k in range(self.refine_k)]

    def _features(self, pooled: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pooled: (..., P, PH, PW, C), objectness-weighted -> (..., P, F)."""
        f = self.dan(pooled.reshape((-1,) + pooled.shape[-3:]), generator)
        return f.reshape(pooled.shape[:-3] + (f.shape[-1],))

    def _mine(self, prev, boxes0, prop_valid, gt_classes_oh) -> GroundTruth:
        """The mining dispatch of the reference (roi_heads_oicrplus.py:307-323)."""
        if not self.refine_mist:
            return top_k_mining(prev, boxes0, prop_valid, gt_classes_oh)
        if self.mist_type == "wetectron":
            return mist_mining_wetectron(prev, boxes0, prop_valid, gt_classes_oh,
                                         mist_p=self.mist_p, mist_thre=self.mist_thre,
                                         seed_cap=self.seed_cap)
        return mist_mining(prev, boxes0, prop_valid, gt_classes_oh, mist_p=self.mist_p,
                           mist_thre=self.mist_thre, seed_cap=self.seed_cap)

    def losses(self, pooled: torch.Tensor, boxes: torch.Tensor, prop_valid: torch.Tensor,
               gt_classes_oh: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """pooled (4, P, PH, PW, C) views [s1, s1 flip, s2, s2 flip]; boxes
        (4, P, 4) per-view proposals; prop_valid (P,); gt_classes_oh (K,).
        Returns the loss terms (keys starting with "loss") and the per-branch
        metrics; every value is an f32 scalar. Profiler ranges: ``box_head``,
        ``mining``, ``losses``."""
        v, p = pooled.shape[:2]
        nc = self.num_classes
        with record_function("box_head"):
            feats = self._features(pooled, generator).reshape(v * p, -1)   # (4P, F)
            c, d = self.wsddn(feats)
        with record_function("losses"):
            scores_v = torch.stack([wsddn_scores(c[i * p:(i + 1) * p], d[i * p:(i + 1) * p],
                                                 prop_valid) for i in range(v)])
            mil = torch.stack([mil_loss(scores_v[i], gt_classes_oh, self.mean_loss)
                               for i in range(v)]).mean()
        losses = {"loss_cls": mil}

        prev = scores_v.mean(dim=0).detach()          # (P, K)
        prev_boxes_v = None                           # (4, P, K, 4) under BBOX_UPDATE
        pred_view = (0, 1, 2, 2)                      # the view-3 quirk
        nv = prop_valid.float().sum()
        for k, branch in enumerate(self.refine):
            term_weight = 3.0 if k == 0 and not self.refine_mist and not self.refine_reg[0] else 1.0
            with record_function("mining"):
                gt = self._mine(prev, boxes[0], prop_valid, gt_classes_oh)
                if prev_boxes_v is not None:
                    # seeds carry the flip-averaged regressed box of their
                    # (proposal, class) instead of the raw proposal
                    gt = GroundTruth(prev_boxes_v[0][gt.index, gt.classes], gt.classes,
                                     gt.scores, gt.weights, gt.index, gt.valid)
                cls, weights, index, fgm = label_and_sample(gt, boxes[0], prop_valid,
                                                            self.matcher, nc)
                safe_cls = cls.clamp(0, nc - 1)
            with record_function("box_head"):
                sc, dl = branch(feats)
                sc = sc.reshape(v, p, -1)
                dl = dl.reshape(v, p, -1)
            with record_function("losses"):
                ce_terms, reg_terms = [], []
                for view in range(v):
                    pv = pred_view[view]
                    ce_terms.append(weighted_ce_loss(sc[pv], cls, weights, prop_valid))
                    if self.refine_reg[k]:
                        # under BBOX_UPDATE only view 0 regresses toward the
                        # regressed pseudo box; the others use their raw
                        # proposal at the pseudo-GT's index
                        if prev_boxes_v is not None and view == 0:
                            gt_boxes_view = prev_boxes_v[0][index, safe_cls]
                        else:
                            gt_boxes_view = boxes[view][index]
                        reg_terms.append(box_reg_loss(
                            dl[pv], boxes[view], gt_boxes_view, cls, prop_valid,
                            num_classes=nc, beta=self.smooth_l1_beta,
                            weights=self.bbox_reg_weights))
                losses[f"loss_cls_r{k}"] = torch.stack(ce_terms).mean() * term_weight
                if self.refine_reg[k]:
                    losses[f"loss_box_reg_r{k}"] = torch.stack(reg_terms).mean() * term_weight

                # per-branch metrics (keys not starting with "loss": not in the total)
                n_fg = fgm.float().sum()
                pred = torch.argmax(sc.detach(), dim=-1)                  # (4, P)
                hit = pred == cls[None]
                acc = (hit & prop_valid[None]).sum(dim=1) / nv.clamp(min=1)
                fg_acc = (hit & fgm[None]).sum(dim=1) / n_fg.clamp(min=1)
                fneg = ((pred == nc) & fgm[None]).sum(dim=1) / n_fg.clamp(min=1)
                losses[f"roi_head/num_fg_samples_r{k}"] = n_fg
                losses[f"roi_head/num_bg_samples_r{k}"] = (prop_valid & (cls == nc)).float().sum()
                losses[f"roi_head/num_ig_samples_r{k}"] = (prop_valid & (cls == -1)).float().sum()
                losses[f"fast_rcnn/cls_accuracy_r{k}"] = acc.mean()
                losses[f"fast_rcnn/fg_cls_accuracy_r{k}"] = fg_acc.mean()
                losses[f"fast_rcnn/false_negative_r{k}"] = fneg.mean()

                prev = torch.softmax(sc.float(), dim=-1).mean(dim=0).detach()
                if self.bbox_update and self.refine_reg[k]:
                    prev_boxes_v = self._updated_boxes(dl.detach().float(), boxes)
        return losses

    def _updated_boxes(self, dl: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Flip-consistent average of the 4 views' deltas (views 1 and 3 are
        hflipped, so their dx enters negated), decoded against each view's
        proposals: (4, P, K*4) deltas -> (4, P, K, 4) boxes."""
        v, p = dl.shape[:2]
        nc = self.num_classes
        d = dl.reshape(v, p, nc, 4)
        sign = torch.tensor([1.0, -1.0, 1.0, -1.0], device=d.device)[:, None, None]
        dx = (d[..., 0] * sign).mean(dim=0)                     # (P, K)
        rest = d[..., 1:].mean(dim=0)                           # (P, K, 3)
        return torch.stack([
            apply_deltas(torch.cat([(dx * s)[..., None], rest], dim=-1).reshape(p, nc * 4),
                         boxes[view], self.bbox_reg_weights).reshape(p, nc, 4)
            for view, s in zip(range(v), (1.0, -1.0, 1.0, -1.0))])

    def predict(self, pooled: torch.Tensor, boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Branch-ensembled inference (reference fast_rcnn_oicr.py:674-736):
        mean softmax over the K branches and mean deltas, decoded against the
        proposals. Returns (scores (P, K+1), pred_boxes (P, K*4)), float32."""
        feats = self._features(pooled)
        probs = None
        deltas = None
        for branch in self.refine:
            sc, dl = branch(feats)
            pk = torch.softmax(sc.float(), dim=-1)
            probs = pk if probs is None else probs + pk
            dk = dl.float()
            deltas = dk if deltas is None else deltas + dk
        probs = probs / self.refine_k
        deltas = deltas / self.refine_k
        return probs, apply_deltas(deltas, boxes.float(), self.bbox_reg_weights)
