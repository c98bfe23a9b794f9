"""Plain reference of the stage-1 OICR+ model, in float32 or in float8.

The model of the OICR+ recipe (Tang et al., OICR, arXiv:1704.00138, with
the refinements of the SoS-WSOD code release): VGG16 with a dilated conv5
(stride 8; plain1 and plain2 frozen), features zeroed beyond each image's
valid extent; ROIPool 7 x 7 of each proposal times its objectness + 1; the
DAN box head 25088 -> 4096 -> 4096, ReLU and dropout; WSDDN's MIL loss
(softmax over classes times softmax over proposals, BCE of the clamped
image scores); K refinement branches, each labelled by MIST mining of the
branch before (per present class the top max(int(n * p), 1) proposals,
the first always and the others above a score threshold, then one
class-agnostic NMS at IoU 0.01), matched at IoU [0.5, 0.6) ignored and
>= 0.6 foreground, with a weighted cross entropy and an L1 box loss, both
over the proposal count, view 3 scored by view 2's branch output (a quirk
of the released code). Training takes one image as 4 views (2 scales x
flip). SGD with momentum, weight decay added to the gradient, biases at
twice the learning rate without decay. Inference averages the K branches'
softmax and deltas, decodes, clips, and keeps per class by NMS the top
detections.

Dropout masks come from a generator seeded as the configuration states,
drawn as (rows, width) uniforms kept at >= the rate, fc1's then fc2's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .ops import (Precision, apply_deltas, get_deltas, iou, nms_keep, rescale, roi_pool,
                  top_detections)

VGG = (("plain1", 3, 64, 2, 1, 2), ("plain2", 64, 128, 2, 1, 2), ("plain3", 128, 256, 3, 1, 2),
       ("plain4", 256, 512, 3, 1, 1), ("plain5", 512, 512, 3, 2, 0))
FROZEN = ("plain1", "plain2")


def settings(cfg: Dict) -> Dict:
    """The numbers the reference reads from a configuration tree."""
    m, wsl, s = cfg["MODEL"], cfg["WSL"], cfg["SOLVER"]
    return {"num_classes": m["ROI_HEADS"]["NUM_CLASSES"], "refine_k": wsl["REFINE_NUM"],
            "mist_p": wsl["MIST_P"], "mist_thre": wsl["MIST_THRE"],
            "seed_cap": cfg["TPU"]["PGT_SEED_CAPACITY"], "dan": list(m["ROI_BOX_HEAD"]["DAN_DIM"]),
            "dropout": 0.5, "pixel_mean": list(m["PIXEL_MEAN"]), "pixel_std": list(m["PIXEL_STD"]),
            "score_thresh": m["ROI_HEADS"]["SCORE_THRESH_TEST"],
            "nms_thresh": m["ROI_HEADS"]["NMS_THRESH_TEST"],
            "detections": cfg["TEST"]["DETECTIONS_PER_IMAGE"], "lr": s["BASE_LR"],
            "momentum": s["MOMENTUM"], "weight_decay": s["WEIGHT_DECAY"],
            "bias_lr": s["BIAS_LR_FACTOR"], "bias_decay": s["WEIGHT_DECAY_BIAS"],
            "seed": cfg["SEED"]}


def param_shapes(st: Dict) -> Dict[str, tuple]:
    shapes = {}
    for name, cin, cout, n, _, _ in VGG:
        for i in range(n):
            shapes[f"backbone.{name}.conv{i + 1}.weight"] = (cout, cin if i == 0 else cout, 3, 3)
            shapes[f"backbone.{name}.conv{i + 1}.bias"] = (cout,)
    dims = [512 * 49, *st["dan"]]
    for i in range(len(st["dan"])):
        shapes[f"roi_heads.dan.fc{i + 1}.weight"] = (dims[i + 1], dims[i])
        shapes[f"roi_heads.dan.fc{i + 1}.bias"] = (dims[i + 1],)
    f, nc = dims[-1], st["num_classes"]
    for head in ("cls", "det"):
        shapes[f"roi_heads.wsddn.{head}.weight"] = (nc, f)
        shapes[f"roi_heads.wsddn.{head}.bias"] = (nc,)
    for k in range(st["refine_k"]):
        shapes[f"roi_heads.box_refinery_{k}.cls_score.weight"] = (nc + 1, f)
        shapes[f"roi_heads.box_refinery_{k}.cls_score.bias"] = (nc + 1,)
        shapes[f"roi_heads.box_refinery_{k}.bbox_pred.weight"] = (nc * 4, f)
        shapes[f"roi_heads.box_refinery_{k}.bbox_pred.bias"] = (nc * 4,)
    return shapes


def trained(name: str) -> bool:
    return not any(f"backbone.{s}." in name for s in FROZEN)


def backbone(images, valid_hw, w, st, prec: Precision) -> torch.Tensor:
    """(N, H, W, 3) raw BGR, (N, 2) -> plain5 (N, H/8, W/8, 512)."""
    mean = torch.tensor(st["pixel_mean"], device=images.device)
    std = torch.tensor(st["pixel_std"], device=images.device)
    x = ((images.float() - mean) / std).permute(0, 3, 1, 2)
    v = valid_hw.long()
    for name, _, _, n, dil, pool in VGG:
        for i in range(n):
            x = F.relu(prec.conv(x, w[f"backbone.{name}.conv{i + 1}.weight"],
                                 w[f"backbone.{name}.conv{i + 1}.bias"], padding=dil,
                                 dilation=dil))
        if pool:
            x = F.max_pool2d(x, 2, stride=pool)
            v = torch.clamp(torch.div(v - 2, pool, rounding_mode="floor") + 1, min=1)
        rows = torch.arange(x.shape[2], device=x.device)[None, :, None] < v[:, 0, None, None]
        cols = torch.arange(x.shape[3], device=x.device)[None, None, :] < v[:, 1, None, None]
        x = x * (rows & cols)[:, None].float()
    return x.permute(0, 2, 3, 1)


def dan(pooled, w, st, prec: Precision, generator: Optional[torch.Generator]) -> torch.Tensor:
    x = pooled.reshape(pooled.shape[0], -1)
    for i in range(len(st["dan"])):
        x = F.relu(prec.linear(x, w[f"roi_heads.dan.fc{i + 1}.weight"],
                               w[f"roi_heads.dan.fc{i + 1}.bias"]))
        if generator is not None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= st["dropout"]
            x = x * keep.float() * (1.0 / (1.0 - st["dropout"]))
    return x


def branch(feats, w, k: int, prec: Precision):
    pre = f"roi_heads.box_refinery_{k}"
    return (prec.linear(feats, w[f"{pre}.cls_score.weight"], w[f"{pre}.cls_score.bias"]),
            prec.linear(feats, w[f"{pre}.bbox_pred.weight"], w[f"{pre}.bbox_pred.bias"]))


def wsddn_scores(c, d, valid):
    cls_sm = torch.softmax(c, dim=1)
    d = torch.where(valid[:, None], d, float("-inf"))
    det = torch.where(valid[:, None], torch.exp(d - d.max(0, keepdim=True).values), 0.0)
    det = det / det.sum(0, keepdim=True).clamp(min=1e-20)
    return torch.where(valid[:, None], cls_sm * det, 0.0)


def mil_loss(scores, labels):
    p = scores.sum(0).clamp(1e-6, 1 - 1e-6)
    return (-(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))).mean()


def _top(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def mist(prev, boxes, valid, labels, st):
    """MIST seeds: (boxes, classes, weights, index, valid) of at most
    seed_cap seeds."""
    k, p = labels.shape[0], valid.shape[0]
    kmax = min(int(p * st["mist_p"]) + 1, p)
    budget = (valid.sum().float() * st["mist_p"]).long().clamp(min=1)
    vals, idxs = _top(torch.where(valid[:, None], prev[:, :k], float("-inf")).T, kmax)
    rank = torch.arange(kmax, device=prev.device)
    ok = (labels.bool()[:, None] & (rank < budget) & ((rank == 0) | (vals >= st["mist_thre"]))
          & torch.isfinite(vals))
    bonus = torch.where(rank == 0, 1e4, 0.0).expand_as(vals).reshape(-1)
    take = _top(torch.where(ok.reshape(-1), vals.reshape(-1) + bonus, float("-inf")),
                min(st["seed_cap"], vals.numel()))[1]
    s_score, s_idx, s_ok = vals.reshape(-1)[take], idxs.reshape(-1)[take], ok.reshape(-1)[take]
    s_cls = torch.arange(k, device=prev.device).repeat_interleave(kmax)[take]
    s_box = boxes[s_idx]
    keep = nms_keep(s_box, s_score, s_ok, 0.01) & s_ok
    return s_box, s_cls, s_score, s_idx, keep


def assign(seeds, boxes, valid, nc):
    """Each proposal's class (nc background, -1 ignored), weight, seed index."""
    s_box, s_cls, s_w, s_idx, s_ok = seeds
    q = torch.where(s_ok[:, None], iou(s_box, boxes), -1.0)
    best, m = q.max(0).values, torch.argmax(q, 0)
    label = torch.where(best >= 0.6, 1, torch.where(best >= 0.5, -1, 0))
    cls = torch.where(label == 1, s_cls[m], torch.where(label == 0, nc, -1))
    wts = torch.where(cls == -1, 0.0, s_w[m])
    wts = torch.where(s_ok.any(), wts, 0.0)
    fg = valid & (cls >= 0) & (cls < nc)
    return cls, wts, s_idx[m], fg


def ce_loss(logits, cls, wts, valid):
    active = valid & (cls >= 0)
    safe = cls.clamp(0, logits.shape[1] - 1)
    ce = torch.logsumexp(logits, 1) - torch.gather(logits, 1, safe[:, None])[:, 0]
    return torch.where(active, ce * wts, 0.0).sum() / valid.float().sum().clamp(min=1)


def reg_loss(deltas, props, gt_boxes, cls, valid, nc):
    fg = valid & (cls >= 0) & (cls < nc)
    safe = cls.clamp(0, nc - 1)
    d = torch.gather(deltas.reshape(-1, nc, 4), 1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
    per = (d - get_deltas(props, gt_boxes)).abs().sum(1)
    return torch.where(fg, per, 0.0).sum() / valid.float().sum().clamp(min=1)


def losses(batch: Dict[str, torch.Tensor], w, st, prec: Precision,
           generator: Optional[torch.Generator], seeds: Optional[List[tuple]] = None,
           mined: Optional[List[tuple]] = None,
           look: Optional[List[Dict]] = None) -> Dict[str, torch.Tensor]:
    """One image's loss terms (4 views). ``seeds``: each branch's mined
    seeds (proposal index, class, kept) to follow in place of mining again,
    their weights this model's scores, or a fourth entry's weights where
    given; else each branch's own mining result is appended to ``mined``.
    ``look`` gets each branch's own scores at the seeds, their kept flags
    and the number of foreground proposals."""
    feats = []
    for s in ("s1", "s2"):
        f = backbone(batch[f"images_{s}"], batch[f"valid_hw_{s}"], w, st, prec)
        feats += [f[0], f[1]]
    valid, boxes = batch["prop_valid"], batch["boxes"].float()
    obn = batch["objectness"].float() + 1.0
    pooled = torch.stack([roi_pool(feats[i], boxes[i], valid, obn) for i in range(4)])
    v, p = pooled.shape[:2]
    x = dan(pooled.reshape((v * p,) + pooled.shape[2:]), w, st, prec, generator)
    c = prec.linear(x, w["roi_heads.wsddn.cls.weight"], w["roi_heads.wsddn.cls.bias"])
    d = prec.linear(x, w["roi_heads.wsddn.det.weight"], w["roi_heads.wsddn.det.bias"])
    labels = batch["gt_classes_oh"].float()
    scores = torch.stack([wsddn_scores(c[i * p:(i + 1) * p], d[i * p:(i + 1) * p], valid)
                          for i in range(v)])
    out = {"loss_cls": torch.stack([mil_loss(scores[i], labels) for i in range(v)]).mean()}
    prev = scores.mean(0).detach()
    nc = st["num_classes"]
    for k in range(st["refine_k"]):
        if seeds is None:
            found = mist(prev, boxes[0], valid, labels, st)
            if mined is not None:
                mined.append((found[3], found[1], found[4]))
        else:
            idx, cls_k, keep = seeds[k][:3]
            given = seeds[k][3].float() if len(seeds[k]) > 3 else prev[idx, cls_k]
            found = (boxes[0][idx], cls_k, given, idx, keep)
        cls, wts, index, fg = assign(found, boxes[0], valid, nc)
        if look is not None:
            look.append({"scores": prev[found[3], found[1]], "kept": found[4],
                         "fg": int(fg.sum())})
        sc, dl = branch(x, w, k, prec)
        sc, dl = sc.reshape(v, p, -1), dl.reshape(v, p, -1)
        ce, reg = [], []
        for view, pv in enumerate((0, 1, 2, 2)):
            ce.append(ce_loss(sc[pv], cls, wts, valid))
            reg.append(reg_loss(dl[pv], boxes[view], boxes[view][index], cls, valid, nc))
        out[f"loss_cls_r{k}"] = torch.stack(ce).mean()
        out[f"loss_box_reg_r{k}"] = torch.stack(reg).mean()
        prev = torch.softmax(sc, -1).mean(0).detach()
    return out


class Trainer:
    """SGD over the trained weights of ``w`` (float32 leaves), one image a
    step; ``step(batch)`` returns the total loss and the MIL loss;
    ``grad1`` holds the first step's gradients."""

    def __init__(self, w: Dict[str, torch.Tensor], st: Dict, prec: Precision, device):
        self.w = {k: (t.clone().requires_grad_(trained(k))) for k, t in w.items()}
        self.st, self.prec = st, prec
        self.buf: Dict[str, torch.Tensor] = {}
        self.grad1: Optional[Dict[str, torch.Tensor]] = None
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(st["seed"])

    def step(self, batch, seeds: Optional[List[tuple]] = None) -> Dict[str, float]:
        """One SGD step on ``batch``, following ``seeds`` (each branch's
        mined seeds) when given; its own mining is kept in ``mined``."""
        self.mined: List[tuple] = []
        self.look: List[Dict] = []
        terms = losses(batch, self.w, self.st, self.prec, self.generator, seeds, self.mined,
                       self.look)
        total = sum(v for k, v in terms.items() if k.startswith("loss"))
        names = [k for k, t in self.w.items() if t.requires_grad]
        grads = torch.autograd.grad(total, [self.w[k] for k in names])
        st = self.st
        with torch.no_grad():
            if self.grad1 is None:
                self.grad1 = dict(zip(names, grads))
            for k, g in zip(names, grads):
                bias = k.endswith(".bias")
                p = self.w[k]
                dp = g + (st["bias_decay"] if bias else st["weight_decay"]) * p
                self.buf[k] = dp.clone() if k not in self.buf else \
                    self.buf[k] * st["momentum"] + dp
                p -= st["lr"] * (st["bias_lr"] if bias else 1.0) * self.buf[k]
        return {"total_loss": float(total.detach()), "loss_cls": float(terms["loss_cls"].detach())}


def predict(sample: Dict[str, torch.Tensor], w, st, prec: Precision):
    """One test image -> (detections (boxes, scores, classes) in the
    original image, every proposal's class scores (P, K) and boxes (P, K,
    4) in the original image)."""
    feat = backbone(sample["image"][None], sample["valid_hw"][None], w, st, prec)[0]
    valid = sample["prop_valid"]
    pooled = roi_pool(feat, sample["boxes"].float(), valid, sample["objectness"].float() + 1.0)
    x = dan(pooled, w, st, prec, None)
    probs, deltas = 0.0, 0.0
    for k in range(st["refine_k"]):
        sc, dl = branch(x, w, k, prec)
        probs = probs + torch.softmax(sc, -1)
        deltas = deltas + dl
    probs, deltas = probs / st["refine_k"], deltas / st["refine_k"]
    nc = st["num_classes"]
    pred = apply_deltas(deltas, sample["boxes"].float())
    hw, orig = sample["image_hw"], sample["orig_hw"]
    boxes, scores, classes = top_detections(pred, probs[:, :nc], valid, hw,
                                            st["score_thresh"], st["nms_thresh"],
                                            st["detections"])
    all_boxes = rescale(torch.minimum(pred.reshape(-1, nc, 4).clamp(min=0),
                                      torch.stack([hw[1], hw[0], hw[1], hw[0]])), hw, orig)
    return (rescale(boxes, hw, orig), scores, classes), probs[:, :nc], all_boxes


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.detach().float().norm()) for k, t in tensors.items()}


def names_trained(st: Dict) -> List[str]:
    return [k for k in param_shapes(st) if trained(k)]
