"""Plain reference of the stage-2/3 detector, Faster R-CNN R50-FPN
(detectron2's published model: Ren et al., arXiv:1506.01497; Lin et al.,
arXiv:1612.03144), inference of one image, in float32 or in float8.

ResNet-50 (caffe2 layout: the stride in each stage's first 1x1 conv),
FrozenBN as y = x * w / sqrt(var + 1e-5) + (b - mean * w / sqrt(var +
1e-5)), the whole padded canvas normalized; FPN: 1x1 laterals, nearest x2
top-down sum, 3x3 outputs, p6 a stride-2 subsample of p5; RPN: a shared
3x3 conv, 3 anchors a cell (sizes 32..512 on p2..p6, ratios 0.5, 1, 2,
corners at (index + offset) * stride), deltas decoded at weights 1, the top
k of each level, clipped, boxes of positive size, NMS at 0.7 within each
level, the top k over all levels; ROIAlignV2 (half-pixel offset, an
adaptive grid of ceil(bin) samples a side, at most 8 as the system's
package states, where detectron2 has no cap) of each proposal on the level
floor(4 + log2(sqrt(area) / 224)) in [2, 5]; two 1024 fc layers, class
scores and class-specific deltas (10, 10, 5, 5); softmax, per-class NMS
above the score threshold and the top detections.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .ops import Precision, apply_deltas, nms_keep, rescale, top_detections

BLOCKS = {14: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
NORM = ("weight", "bias", "running_mean", "running_var")
LEVELS = ("p2", "p3", "p4", "p5", "p6")
STRIDES = (4, 8, 16, 32, 64)


def settings(cfg: Dict) -> Dict:
    m = cfg["MODEL"]
    return {"num_classes": m["ROI_HEADS"]["NUM_CLASSES"], "depth": m["RESNETS"]["DEPTH"],
            "fpn": m["FPN"]["OUT_CHANNELS"], "pixel_mean": list(m["PIXEL_MEAN"]),
            "pixel_std": list(m["PIXEL_STD"]),
            "anchor_sizes": [list(s) for s in m["ANCHOR_GENERATOR"]["SIZES"]],
            "ratios": list(m["ANCHOR_GENERATOR"]["ASPECT_RATIOS"][0]),
            "anchor_offset": m["ANCHOR_GENERATOR"]["OFFSET"],
            "pre_topk": m["RPN"]["PRE_NMS_TOPK_TEST"], "post_topk": m["RPN"]["POST_NMS_TOPK_TEST"],
            "rpn_nms": m["RPN"]["NMS_THRESH"], "min_size": m["PROPOSAL_GENERATOR"]["MIN_SIZE"],
            "res": m["ROI_BOX_HEAD"]["POOLER_RESOLUTION"],
            "aligned": m["ROI_BOX_HEAD"]["POOLER_TYPE"] == "ROIAlignV2",
            "fc": [m["ROI_BOX_HEAD"]["FC_DIM"]] * m["ROI_BOX_HEAD"]["NUM_FC"],
            "score_thresh": m["ROI_HEADS"]["SCORE_THRESH_TEST"],
            "nms_thresh": m["ROI_HEADS"]["NMS_THRESH_TEST"],
            "detections": cfg["TEST"]["DETECTIONS_PER_IMAGE"]}


def _blocks(st: Dict):
    """(name, in, out, bottleneck, stride) of each bottleneck block."""
    out, cin, cout, bott = [], 64, 256, 64
    for stage, n in enumerate(BLOCKS[st["depth"]], start=2):
        for b in range(n):
            out.append((f"res{stage}_block{b}", cin if b == 0 else cout, cout, bott,
                        (1 if stage == 2 else 2) if b == 0 else 1))
        cin, cout, bott = cout, cout * 2, bott * 2
    return out


def param_shapes(st: Dict) -> Dict[str, tuple]:
    bu, f = "backbone.bottom_up.", st["fpn"]
    shapes = {bu + "stem.conv1.weight": (64, 3, 7, 7)}
    shapes.update({bu + f"stem.conv1_norm.{n}": (64,) for n in NORM})
    for name, cin, cout, bott, stride in _blocks(st):
        convs = [("conv1", bott, cin, 1), ("conv2", bott, bott, 3), ("conv3", cout, bott, 1)]
        if cin != cout or stride != 1:
            convs.append(("shortcut", cout, cin, 1))
        for conv, o, i, k in convs:
            shapes[f"{bu}{name}.{conv}.weight"] = (o, i, k, k)
            shapes.update({f"{bu}{name}.{conv}_norm.{n}": (o,) for n in NORM})
    for i, cin in enumerate((256, 512, 1024, 2048), start=2):
        shapes[f"backbone.fpn.fpn_lateral{i}.weight"] = (f, cin, 1, 1)
        shapes[f"backbone.fpn.fpn_lateral{i}.bias"] = (f,)
        shapes[f"backbone.fpn.fpn_output{i}.weight"] = (f, f, 3, 3)
        shapes[f"backbone.fpn.fpn_output{i}.bias"] = (f,)
    a = len(st["ratios"])
    for name, o, k in (("conv", f, 3), ("objectness_logits", a, 1), ("anchor_deltas", 4 * a, 1)):
        shapes[f"proposal_generator.head.{name}.weight"] = (o, f, k, k)
        shapes[f"proposal_generator.head.{name}.bias"] = (o,)
    d = f * st["res"] ** 2
    for i, o in enumerate(st["fc"], start=1):
        shapes[f"roi_heads.box_head.fc{i}.weight"] = (o, d)
        shapes[f"roi_heads.box_head.fc{i}.bias"] = (o,)
        d = o
    nc = st["num_classes"]
    shapes["roi_heads.box_predictor.cls_score.weight"] = (nc + 1, d)
    shapes["roi_heads.box_predictor.cls_score.bias"] = (nc + 1,)
    shapes["roi_heads.box_predictor.bbox_pred.weight"] = (4 * nc, d)
    shapes["roi_heads.box_predictor.bbox_pred.bias"] = (4 * nc,)
    return shapes


def _frozen_bn(x, w, prefix):
    scale = w[prefix + ".weight"] * torch.rsqrt(w[prefix + ".running_var"] + 1e-5)
    shift = w[prefix + ".bias"] - w[prefix + ".running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def features(image, w, st, prec: Precision) -> Dict[str, torch.Tensor]:
    """(H, W, 3) raw BGR canvas -> p2..p6, (1, C, h, w)."""
    mean = torch.tensor(st["pixel_mean"], device=image.device)
    std = torch.tensor(st["pixel_std"], device=image.device)
    x = ((image.float() - mean) / std).permute(2, 0, 1)[None]
    bu = "backbone.bottom_up."
    x = F.relu(_frozen_bn(prec.conv(x, w[bu + "stem.conv1.weight"], None, stride=2, padding=3),
                          w, bu + "stem.conv1_norm"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    res = {}
    for name, cin, cout, _, stride in _blocks(st):
        p = bu + name
        out = F.relu(_frozen_bn(prec.conv(x, w[p + ".conv1.weight"], None, stride=stride),
                                w, p + ".conv1_norm"))
        out = F.relu(_frozen_bn(prec.conv(out, w[p + ".conv2.weight"], None, padding=1),
                                w, p + ".conv2_norm"))
        out = _frozen_bn(prec.conv(out, w[p + ".conv3.weight"], None), w, p + ".conv3_norm")
        if cin != cout or stride != 1:
            x = _frozen_bn(prec.conv(x, w[p + ".shortcut.weight"], None, stride=stride),
                           w, p + ".shortcut_norm")
        x = F.relu(out + x)
        res[name.split("_")[0]] = x
    lat = [prec.conv(res[f"res{i}"], w[f"backbone.fpn.fpn_lateral{i}.weight"],
                     w[f"backbone.fpn.fpn_lateral{i}.bias"]) for i in range(2, 6)]
    merged = [None] * 4
    merged[3] = lat[3]
    for i in range(2, -1, -1):
        h, wd = lat[i].shape[-2:]
        merged[i] = lat[i] + F.interpolate(merged[i + 1], scale_factor=2.0,
                                           mode="nearest")[..., :h, :wd]
    out = {f"p{i + 2}": prec.conv(merged[i], w[f"backbone.fpn.fpn_output{i + 2}.weight"],
                                  w[f"backbone.fpn.fpn_output{i + 2}.bias"], padding=1)
           for i in range(4)}
    out["p6"] = out["p5"][..., ::2, ::2]
    return out


def anchors(h: int, w: int, stride: int, sizes, ratios, offset: float, device) -> torch.Tensor:
    cell = []
    for s in sizes:
        for r in ratios:
            aw = math.sqrt(s * s / r)
            ah = r * aw
            cell.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)
    ys = (torch.arange(h, dtype=torch.float32, device=device) + offset) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=device) + offset) * stride
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1)
    return (shifts[:, :, None, :] + cell[None, None]).reshape(-1, 4)


def rpn(feats, image_hw, w, st, prec: Precision):
    """(proposals (post, 4), their logits, valid), and every anchor's
    decoded, clipped box, logit and size (its longer side) over all
    levels."""
    hw = image_hw.float()
    lim = torch.stack([hw[1], hw[0], hw[1], hw[0]])
    head = "proposal_generator.head."
    cands, every_box, every_logit, every_size = [], [], [], []
    for lvl, (name, stride) in enumerate(zip(LEVELS, STRIDES)):
        f = feats[name]
        t = F.relu(prec.conv(f, w[head + "conv.weight"], w[head + "conv.bias"], padding=1))
        logits = prec.conv(t, w[head + "objectness_logits.weight"],
                           w[head + "objectness_logits.bias"])[0].permute(1, 2, 0).reshape(-1)
        deltas = prec.conv(t, w[head + "anchor_deltas.weight"],
                           w[head + "anchor_deltas.bias"])[0].permute(1, 2, 0).reshape(-1, 4)
        a = anchors(f.shape[-2], f.shape[-1], stride, st["anchor_sizes"][lvl], st["ratios"],
                    st["anchor_offset"], f.device)
        boxes = torch.minimum(apply_deltas(deltas, a, (1.0, 1.0, 1.0, 1.0)).clamp(min=0), lim)
        every_box.append(boxes)
        every_logit.append(logits)
        every_size.append(torch.maximum(a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]))
        k = min(st["pre_topk"], logits.shape[0])
        top, idx = torch.sort(logits, descending=True, stable=True)
        top, b = top[:k], boxes[idx[:k]]
        ok = ((b[:, 2] - b[:, 0]) > st["min_size"]) & ((b[:, 3] - b[:, 1]) > st["min_size"])
        ok &= torch.isfinite(top)
        keep = nms_keep(b, top, ok, st["rpn_nms"]) & ok
        cands.append((torch.where(keep, top, float("-inf")), b))
    scores = torch.cat([c[0] for c in cands])
    boxes = torch.cat([c[1] for c in cands])
    top, idx = torch.sort(scores, descending=True, stable=True)
    top, idx = top[:st["post_topk"]], idx[:st["post_topk"]]
    valid = torch.isfinite(top)
    return ((torch.where(valid[:, None], boxes[idx], 0.0), torch.where(valid, top, 0.0), valid),
            (torch.cat(every_box), torch.cat(every_logit), torch.cat(every_size)))


def roi_align(feats: List[torch.Tensor], strides, boxes, valid, res: int, aligned: bool,
              cap: int = 8) -> torch.Tensor:
    """Each box pooled on its level: features (1, C, h, w) per level ->
    (P, res, res, C)."""
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).clamp(min=1e-8)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8)).clamp(2, 5).long() - 2
    c = feats[0].shape[1]
    out = torch.zeros((boxes.shape[0], res, res, c), device=boxes.device)
    g = torch.arange(res, dtype=torch.float32, device=boxes.device)
    for li, (f, stride) in enumerate(zip(feats, strides)):
        sel = torch.nonzero(valid & (lvl == li)).flatten()
        if sel.numel() == 0:
            continue
        h, w = f.shape[-2:]
        fm = f[0].permute(1, 2, 0)
        b = boxes[sel] / stride - (0.5 if aligned else 0.0)
        bw, bh = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
        if not aligned:
            bw, bh = bw.clamp(min=1.0), bh.clamp(min=1.0)
        bin_w, bin_h = bw / res, bh / res
        gw = torch.ceil(bin_w).clamp(1, cap)
        gh = torch.ceil(bin_h).clamp(1, cap)
        acc = torch.zeros((sel.numel(), res, res, c), device=boxes.device)
        for iy in range(cap):
            y = b[:, 1, None] + g[None] * bin_h[:, None] + ((iy + 0.5) / gh)[:, None] * bin_h[:, None]
            for ix in range(cap):
                x = b[:, 0, None] + g[None] * bin_w[:, None] + \
                    ((ix + 0.5) / gw)[:, None] * bin_w[:, None]
                ok = ((iy < gh) & (ix < gw)).float()
                acc += _bilinear(fm, y[:, :, None].expand(-1, res, res),
                                 x[:, None, :].expand(-1, res, res), h, w) * ok[:, None, None, None]
        out[sel] = acc / (gh * gw)[:, None, None, None]
    return out


def _bilinear(fm, y, x, h: int, w: int) -> torch.Tensor:
    """detectron2's bilinear sample of (h, w, C) at (y, x): zero beyond
    [-1, h] x [-1, w], coordinates below 0 taken as 0, the last row and
    column held at the border."""
    oob = (y < -1) | (y > h) | (x < -1) | (x > w)
    y, x = y.clamp(min=0), x.clamp(min=0)
    y0 = torch.minimum(y.long(), torch.tensor(h - 1, device=y.device))
    x0 = torch.minimum(x.long(), torch.tensor(w - 1, device=y.device))
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    y = torch.where(y0 >= h - 1, float(h - 1), y)
    x = torch.where(x0 >= w - 1, float(w - 1), x)
    ly, lx = y - y0, x - x0
    hy, hx = 1 - ly, 1 - lx
    v = (fm[y0, x0] * (hy * hx)[..., None] + fm[y0, x1] * (hy * lx)[..., None]
         + fm[y1, x0] * (ly * hx)[..., None] + fm[y1, x1] * (ly * lx)[..., None])
    return torch.where(oob[..., None], 0.0, v)


def box_stage(feats, proposals: Tuple[torch.Tensor, torch.Tensor], w, st, prec: Precision):
    """Class probabilities (P, K + 1) and boxes (P, 4K) of the proposals."""
    boxes, valid = proposals
    pooled = roi_align([feats[f] for f in LEVELS[:4]], STRIDES[:4], boxes, valid, st["res"],
                       st["aligned"])
    x = pooled.reshape(pooled.shape[0], -1)
    for i in range(1, len(st["fc"]) + 1):
        x = F.relu(prec.linear(x, w[f"roi_heads.box_head.fc{i}.weight"],
                               w[f"roi_heads.box_head.fc{i}.bias"]))
    p = "roi_heads.box_predictor."
    scores = prec.linear(x, w[p + "cls_score.weight"], w[p + "cls_score.bias"])
    deltas = prec.linear(x, w[p + "bbox_pred.weight"], w[p + "bbox_pred.bias"])
    return torch.softmax(scores, -1), apply_deltas(deltas, boxes)


def to_original(pred: torch.Tensor, hw: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """Boxes (P, 4K) on the canvas -> (P, K, 4), clipped to the image and
    in the original image, as the detections are."""
    return rescale(torch.minimum(pred.reshape(pred.shape[0], -1, 4).clamp(min=0),
                                 torch.stack([hw[1], hw[0], hw[1], hw[0]])), hw, orig)


def predict(sample: Dict[str, torch.Tensor], w, st, prec: Precision,
            proposals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One test image -> (detections in the original image, every
    proposal's class scores (P, K) and boxes (P, K, 4) in the original
    image, the RPN's proposals, every anchor's box and logit, every
    proposal's boxes (P, 4K) on the canvas). With ``proposals`` (boxes,
    valid) the box stage runs on them in place of the reference's own."""
    feats = features(sample["image"], w, st, prec)
    hw, orig = sample["image_hw"], sample["orig_hw"]
    props, every = rpn(feats, hw, w, st, prec)
    boxes, valid = (props[0], props[2]) if proposals is None else proposals
    probs, pred = box_stage(feats, (boxes, valid), w, st, prec)
    nc = st["num_classes"]
    det = top_detections(pred, probs[:, :nc], valid, hw, st["score_thresh"], st["nms_thresh"],
                         st["detections"])
    return ((rescale(det[0], hw, orig), det[1], det[2]), probs[:, :nc],
            to_original(pred, hw, orig), props, every, pred)
