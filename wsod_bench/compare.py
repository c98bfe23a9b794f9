"""The numbers that decide ``correct``: the system's readings against the
plain reference's. Each cell's limits file names the ones it compares;
the others are printed.

Training (the first steps that set-up drove through the window's own step
and feed):
  - ``loss_gap``: the largest |loss - reference's| / |reference's| over
    the steps (``loss1_gap`` the first step's; ``mil_gap``, ``mil1_gap``
    the same of the MIL loss);
  - ``grad_gap``: the first gradient, per trained leaf, the gap of the two
    norms over the larger of the reference's norm of that leaf and of the
    median leaf; the largest over the leaves (``grad_gap_median`` the
    median leaf's; ``mil_grad_gap`` the largest over the MIL head's
    leaves);
  - ``change_gap``: the same of each leaf's change after the steps,
    leaving out leaves whose reference gradient is under a thousandth of
    the median leaf's (they move by round-off alone under momentum);
    ``change_gap_median`` the median leaf's.
Inference (a sample, drawn from the seed, of the images the window ran):
  - ``score_gap``: for each detection, the reference's proposal and class
    whose box overlaps it most; the gap of the two scores over the image's
    best reference score (1 where no reference box overlaps it by IoU
    0.5); the largest over the detections;
  - ``box_gap``: 1 - that IoU, the largest over the detections;
  - ``count_gap``: the largest difference of the number of detections of
    an image (exact: limit 0).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

from .reference.ops import iou


MIL_HEAD = "roi_heads.wsddn."


def _gaps(prog: Dict[str, float], refr: Dict[str, float], keys: Sequence[str]) -> List[float]:
    floor = statistics.median(refr[k] for k in keys) if keys else 0.0
    return [abs(prog.get(k, 0.0) - refr[k]) / max(refr[k], floor, 1e-30) for k in keys]


def train_numbers(prog_losses: List[Dict[str, float]], prog_grads: Dict[str, float],
                  prog_change: Dict[str, float], ref_losses: List[Dict[str, float]],
                  ref_grads: Dict[str, float], ref_change: Dict[str, float]) -> Dict[str, float]:
    """``*_losses``: each step's {"total_loss", "loss_cls"}."""
    floor = statistics.median(ref_grads.values())
    moved = [k for k in ref_grads if ref_grads[k] >= 1e-3 * floor]
    grads = _gaps(prog_grads, ref_grads, list(ref_grads))
    change = _gaps(prog_change, ref_change, moved)

    def loss(key, steps):
        return max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                   for a, b in list(zip(prog_losses, ref_losses))[:steps])

    # the MIL head's leaves take the first step's gradient from the MIL
    # loss alone, which mining does not reach
    head = [k for k in moved if k.startswith(MIL_HEAD)]
    return {"loss_gap": loss("total_loss", len(ref_losses)),
            "loss1_gap": loss("total_loss", 1),
            "mil_gap": loss("loss_cls", len(ref_losses)),
            "mil1_gap": loss("loss_cls", 1),
            "grad_gap": max(grads), "change_gap": max(change),
            "grad_gap_median": statistics.median(grads),
            "change_gap_median": statistics.median(change),
            "mil_grad_gap": max(_gaps(prog_grads, ref_grads, head), default=0.0)}


def infer_numbers(pairs) -> Dict[str, float]:
    """``pairs``: (system detections (boxes, scores, classes) as numpy, the
    reference's (detections, class scores (P, K), boxes (P, K, 4)))."""
    score_gap = box_gap = count_gap = 0.0
    for (boxes, scores, classes), ((rb, rs, _), probs, all_boxes) in pairs:
        dev = probs.device
        best = float(probs.max())
        count_gap = max(count_gap, abs(len(scores) - len(rs)))
        for b, s, c in zip(torch.as_tensor(boxes, device=dev).float(),
                           torch.as_tensor(scores, device=dev).float(),
                           torch.as_tensor(classes, device=dev).long()):
            ious = iou(b[None], all_boxes[:, c])[0]
            j = int(torch.argmax(ious))
            overlap = float(ious[j])
            gap = abs(float(s) - float(probs[j, c])) / best if overlap >= 0.5 else 1.0
            score_gap, box_gap = max(score_gap, gap), max(box_gap, 1.0 - overlap)
    return {"score_gap": score_gap, "box_gap": box_gap, "count_gap": float(count_gap)}
