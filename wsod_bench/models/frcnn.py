"""The stage-2/3 Faster R-CNN R50-FPN family: how the benchmark builds the
system's model, what it keeps of the system's predict (each image's last
RPN proposals, which the reference's box stage follows, and the boxes and
scores of every proposal and class, which name each detection's proposal),
what it records at the system's ROIAlign calls in a traced window, the
model's FLOPs, and the plain reference's side of the comparison."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..reference import frcnn as ref
from ..reference.ops import Precision, iou
from ..reference import mapping
from ..work import flops, roofline
from .stage1 import mapping_cfg


def settings(tree: Dict) -> Dict:
    return ref.settings(tree)


def param_shapes(st: Dict) -> Dict[str, tuple]:
    return ref.param_shapes(st)


def build(cfg, weights: Dict[str, torch.Tensor], device):
    from sos_wsod_torch.engine.weights import load_weights
    from sos_wsod_torch.models.meta.rcnn import GeneralizedRCNN

    return load_weights(GeneralizedRCNN.from_cfg(cfg, device="meta"), weights, device)


def predict_flops(sample: Dict[str, np.ndarray], st: Dict) -> float:
    h, w = (int(x) for x in sample["image_hw"])
    return flops.r50_fpn_predict(h, w, st["post_topk"], st["fpn"], st["fc"], st["num_classes"])


@contextlib.contextmanager
def capture(model, cycle: int):
    """While open, keeps in the yielded {position: (RPN proposals (boxes,
    logits, valid), boxes (P, 4K) and scores (P, K + 1) of every proposal
    and class)} what the last ``predict`` of each position in the cycle of
    ``cycle`` images returned."""
    kept: Dict = {}
    calls = [0]
    inner = model.predict

    def predict(batch, **kw):
        out = inner(batch, **kw)
        kept[calls[0] % cycle] = (out[1], out[2][1], out[2][0])
        calls[0] += 1
        return out

    model.predict = predict
    try:
        yield kept
    finally:
        del model.predict


def kept_of_reference(out) -> tuple:
    """What ``capture`` keeps, from the reference's ``predict`` (for the
    control, put in the system's place)."""
    return out[3], out[5], out[1]


@contextlib.contextmanager
def recording(calls: Dict[str, list]):
    """Records each call of the system's multi-level ROIAlign from the box
    head (the levels' shapes and type, the boxes, valid flags and pooler
    settings) into ``calls["roi_align"]``."""
    from sos_wsod_torch.models.roi_heads import standard

    inner = standard.multilevel_roi_align
    rows = calls.setdefault("roi_align", [])

    def pool(features, strides, boxes, valid, **kw):
        rows.append({"levels": [tuple(f.shape) for f in features],
                     "itemsize": features[0].element_size(), "strides": tuple(strides),
                     "boxes": boxes, "valid": valid, "kw": dict(kw)})
        return inner(features, strides, boxes, valid, **kw)

    standard.multilevel_roi_align = pool
    try:
        yield
    finally:
        standard.multilevel_roi_align = inner


def roi_align_bounds(rows: List[Dict]) -> float:
    """Seconds the recorded calls need at least (``work/roofline.py``)."""
    total = 0.0
    for r in rows:
        res = r["kw"].get("output_size", 7)
        aligned = r["kw"].get("aligned", True)
        ratio = r["kw"].get("sampling_ratio", 0)
        b, valid = r["boxes"].float(), r["valid"]
        area = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).clamp(min=1e-8)
        lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8)).clamp(2, 5).long() - 2
        stride = torch.tensor(r["strides"], device=b.device, dtype=torch.float32)[lvl]
        side_w = (b[:, 2] - b[:, 0]) / stride
        side_h = (b[:, 3] - b[:, 1]) / stride
        if not aligned:
            side_w, side_h = side_w.clamp(min=1), side_h.clamp(min=1)
        if ratio > 0:
            grid = torch.full_like(side_w, float(ratio * ratio))
        else:
            grid = torch.ceil(side_h / res).clamp(1, 8) * torch.ceil(side_w / res).clamp(1, 8)
        samples = int((grid * valid.float()).sum()) * res * res
        total += roofline.roi_align_fwd(r["levels"], int(valid.sum()), b.shape[0], res,
                                        r["itemsize"], samples)
    return total


def reference_predict(dicts, tree: Dict, weights: Dict[str, torch.Tensor], device,
                      precision: str = "f32", proposals: Dict = None):
    """{index: (detections, class scores, boxes, RPN proposals, every
    anchor's box and logit, canvas boxes, the system's boxes and scores,
    (canvas extent, original extent))} of the reference, for the test
    mapping of each of ``dicts`` ({index: dict}). Where
    ``proposals[index]``, what ``capture`` kept, is given, the box stage
    follows its proposals (boxes, logits, valid), and its boxes of every
    proposal and class are put in the original image as the reference's
    are."""
    st = settings(tree)
    cfg = mapping_cfg(tree)
    prec = Precision(precision)
    out = {}
    with torch.no_grad():
        for i, d in dicts.items():
            s = {k: torch.as_tensor(a, device=device)
                 for k, a in mapping.test_sample(d, cfg).items()}
            props, boxes, scores = (None,) * 3 if proposals is None else proposals[i]
            out[i] = ref.predict(s, weights, st, prec,
                                 None if props is None else (props[0].float(), props[2]))
            mine = None if boxes is None else (
                ref.to_original(boxes.float(), s["image_hw"], s["orig_hw"]),
                scores[:, :st["num_classes"]].float())
            out[i] += (mine, (s["image_hw"], s["orig_hw"]))
    return out


def rpn_numbers(props, every) -> Dict[str, float]:
    """The system's RPN proposals (boxes, logits, valid) against every
    anchor of the reference's RPN. For each proposal, each anchor's
    distance: the largest coordinate difference between the proposal and
    the anchor's decoded, clipped box, over the anchor's longer side (the
    error of a decoded box grows with its anchor, and clipping makes boxes
    of large anchors equal). ``rpn_box_gap``: the least distance, the
    largest over the proposals. ``rpn_logit_gap``: among the anchors within
    0.02 of the least distance, the least gap of the logits, over the
    reference's largest |logit| among its kept proposals; the largest over
    the proposals. ``rpn_miss``: the share of the proposals that no proposal
    the reference keeps overlaps by IoU 0.8 (selection by top k and NMS)."""
    boxes, logits, valid = props
    ref_props, (ref_boxes, ref_logits, ref_size) = every
    scale = float(ref_props[1][ref_props[2]].abs().max())
    kept = ref_props[0][ref_props[2]].float()
    box_gap = logit_gap = 0.0
    missed = 0
    for chunk, lg in zip(torch.split(boxes[valid].float(), 256),
                         torch.split(logits[valid].float(), 256)):
        d = (chunk[:, None, :] - ref_boxes[None]).abs().amax(-1) / ref_size[None]
        best = d.min(1, keepdim=True).values
        near = torch.where(d <= best + 0.02, (lg[:, None] - ref_logits[None]).abs(),
                           float("inf"))
        box_gap = max(box_gap, float(best.max()))
        logit_gap = max(logit_gap, float(near.min(1).values.max()) / scale)
        missed += int((iou(chunk, kept).max(1).values < 0.8).sum())
    return {"rpn_box_gap": box_gap, "rpn_logit_gap": logit_gap,
            "rpn_miss": missed / max(int(valid.sum()), 1)}


def by_proposal(dets, mine, ref_probs, ref_boxes, props, orig_hw, image_hw,
                floor: float = 4.0) -> tuple:
    """Each detection (box b, score s, class c) of the system against the
    reference's answer for its own proposal j: the one whose box and score
    of class c, among the system's (``mine``: boxes (P, K, 4) in the
    original image, scores (P, K)), are b and s. Returns the largest over
    the detections of (the gap of s from the reference's score of (j, c)
    over the image's best reference score; the largest coordinate gap of b
    from the reference's box of (j, c), x over proposal j's width and y
    over its height in the original image, each at least ``floor`` pixels;
    the distance of (b, s) from the system's own (j, c): 0 but for
    rounding)."""
    boxes, scores = mine
    b, s, c = (torch.as_tensor(a, device=boxes.device) for a in dets)
    if len(c) == 0:
        return 0.0, 0.0, 0.0
    b, s, c = b.float(), s.float(), c.long()
    p_boxes, valid = props[0].float(), props[2]
    own = (boxes[:, c] - b[None]).abs().amax(-1) + (scores[:, c] - s[None]).abs()   # (P, D)
    own = torch.where(valid[:, None], own, float("inf"))
    near, j = own.min(0)
    score_gap = ((s - ref_probs[j, c]).abs() / ref_probs.max()).max()
    scale = (orig_hw.float() / image_hw.float()).flip(0)            # (sx, sy)
    wh = torch.stack([p_boxes[j, 2] - p_boxes[j, 0], p_boxes[j, 3] - p_boxes[j, 1]], -1)
    wh = (wh * scale).clamp(min=floor).repeat(1, 2)                 # (D, 4)
    shift = ((b - ref_boxes[j, c]).abs() / wh).amax()
    return float(score_gap), float(shift), float(near.max())


def check_numbers(program, refs, picks) -> Dict[str, float]:
    """The cell's numbers from the system's detections, proposals, boxes
    and scores of the picked images and the reference's: ``score_gap`` and
    ``box_shift`` by each detection's own proposal (``by_proposal``), the
    others as ``compare.infer_numbers`` and ``rpn_numbers`` give them."""
    from ..compare import infer_numbers

    out = infer_numbers([(program[i][0], refs[i][:3]) for i in picks])
    out["score_gap_iou"] = out.pop("score_gap")
    out["score_gap"] = out["box_shift"] = out["box_own"] = 0.0
    for i in picks:
        props = program[i][1][0]
        for k, v in rpn_numbers(props, (refs[i][3], refs[i][4])).items():
            out[k] = max(out.get(k, 0.0), v)
        hw, orig = refs[i][7]
        got = by_proposal(program[i][0], refs[i][6], refs[i][1], refs[i][2], props, orig, hw)
        for k, v in zip(("score_gap", "box_shift", "box_own"), got):
            out[k] = max(out[k], v)
    return out
