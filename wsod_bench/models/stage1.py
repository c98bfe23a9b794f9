"""The stage-1 OICR+ model family: how the benchmark builds the system's
model, what it records at the system's ROIPool calls in a traced window,
the model's FLOPs, and the plain reference's side of the comparison."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..reference import mapping, stage1 as ref
from ..reference.ops import Precision, bin_windows
from ..work import flops, roofline

TRAIN_RANGES = ("backbone", "roi_pool", "box_head", "mining", "losses", "backward", "optimizer")


def settings(tree: Dict) -> Dict:
    return ref.settings(tree)


def param_shapes(st: Dict) -> Dict[str, tuple]:
    return ref.param_shapes(st)


def build(cfg, weights: Dict[str, torch.Tensor], device):
    """The system's model of ``cfg`` with ``weights``, in eval mode."""
    from sos_wsod_torch.engine.weights import load_weights
    from sos_wsod_torch.models.meta.rcnn_wsl_single import build_stage1_model

    return load_weights(build_stage1_model(cfg, device="meta"), weights, device)


def mapping_cfg(tree: Dict) -> Dict:
    inp, tpu = tree["INPUT"], tree["TPU"]
    return {"crop_size": list(inp["CROP"]["SIZE"]), "min_size_train": list(inp["MIN_SIZE_TRAIN"]),
            "max_size_train": inp["MAX_SIZE_TRAIN"], "min_size_test": inp["MIN_SIZE_TEST"],
            "max_size_test": inp["MAX_SIZE_TEST"],
            "proposal_topk": tree["DATASETS"]["PRECOMPUTED_PROPOSAL_TOPK_TRAIN"],
            "proposal_topk_test": tree["DATASETS"]["PRECOMPUTED_PROPOSAL_TOPK_TEST"],
            "capacity": tpu["PROPOSAL_CAPACITY"], "divisibility": tpu["IMAGE_SIZE_DIVISIBILITY"],
            "num_classes": tree["MODEL"]["ROI_HEADS"]["NUM_CLASSES"]}


# -- work ---------------------------------------------------------------------

def train_flops(batch: List[Dict[str, np.ndarray]], st: Dict) -> float:
    total = 0.0
    for s in batch:
        views = [tuple(int(x) for x in s[f"valid_hw_{k}"][i]) for k in ("s1", "s2")
                 for i in range(2)]
        total += flops.stage1_train_step(views, int(s["prop_valid"].sum()), st["dan"],
                                         st["num_classes"], st["refine_k"])
    return total


def predict_flops(sample: Dict[str, np.ndarray], st: Dict) -> float:
    return flops.stage1_predict(tuple(int(x) for x in sample["valid_hw"]),
                                int(sample["prop_valid"].sum()), st["dan"], st["num_classes"],
                                st["refine_k"])


@contextlib.contextmanager
def recording(calls: Dict[str, list]):
    """Records each call of the system's ROIPool from the stage-1 model
    (its map's shape and type, the boxes and valid flags, whether it keeps
    the argmax for a backward) into ``calls["roi_pool"]``."""
    from sos_wsod_torch.models.meta import rcnn_wsl

    inner = rcnn_wsl.roi_pool
    rows = calls.setdefault("roi_pool", [])

    def pool(feat, boxes, valid, row_scale=None, **kw):
        rows.append({"hwc": tuple(feat.shape), "itemsize": feat.element_size(), "boxes": boxes,
                     "valid": valid, "res": kw["output_size"][0],
                     "scale": kw["spatial_scale"],
                     "grad": feat.requires_grad and torch.is_grad_enabled()})
        return inner(feat, boxes, valid, row_scale, **kw)

    rcnn_wsl.roi_pool = pool
    try:
        yield
    finally:
        rcnn_wsl.roi_pool = inner


def roi_pool_bounds(rows: List[Dict], backward: bool) -> float:
    """Seconds the recorded calls need at least: forward, or the backward
    of those that kept the argmax."""
    total = 0.0
    for r in rows:
        h, w, c = r["hwc"]
        p, res = r["boxes"].shape[0], r["res"]
        if backward:
            if r["grad"]:
                total += roofline.roi_pool_bwd(h, w, c, p, res, r["itemsize"])
            continue
        hs, he, ws, we = bin_windows(r["boxes"], r["valid"], h, w, res, r["scale"])
        cells = int((((he - hs).clamp(min=0)[:, :, None] * (we - ws).clamp(min=0)[:, None, :])
                     * r["valid"][:, None, None]).sum())
        total += roofline.roi_pool_fwd(h, w, c, p, res, r["itemsize"], r["grad"], cells)
    return total


# -- the reference's side -------------------------------------------------------

@contextlib.contextmanager
def recording_mining(calls: List):
    """Records each MIST mining call of the system's stage-1 head: its
    inputs (the branch before's scores, the proposals, their flags, the
    labels) and the seeds it returned (proposal index, class, kept, and
    their weights)."""
    from sos_wsod_torch.models.heads.oicr_plus import OICRPlusHead

    inner = OICRPlusHead._mine

    def mine(self, prev, boxes0, prop_valid, gt_classes_oh):
        gt = inner(self, prev, boxes0, prop_valid, gt_classes_oh)
        calls.append({"inputs": (prev, boxes0, prop_valid, gt_classes_oh),
                      "seeds": (gt.index, gt.classes, gt.valid), "weights": gt.weights})
        return gt

    OICRPlusHead._mine = mine
    try:
        yield
    finally:
        OICRPlusHead._mine = inner


def mining_gap(calls: List, tree: Dict) -> float:
    """The mining stage checked by itself: the reference's MIST on the
    system's own inputs to each call; the share of kept (proposal, class)
    seeds that differ, the largest over the calls (exact: 0)."""
    st = settings(tree)
    worst = 0.0
    with torch.no_grad():
        for c in calls:
            prev, boxes0, valid, labels = c["inputs"]
            mine = ref.mist(prev.float(), boxes0.float(), valid, labels.float(), st)
            theirs = c["seeds"]
            a = {(int(i), int(k)) for i, k, ok in zip(mine[3], mine[1], mine[4]) if ok}
            b = {(int(i), int(k)) for i, k, ok in zip(*theirs) if ok}
            worst = max(worst, len(a ^ b) / max(len(b), 1))
    return worst


def reference_train(dicts, tree: Dict, weights: Dict[str, torch.Tensor], steps: int,
                    device, precision: str = "f32", seeds: List = None):
    """The reference's first ``steps`` steps from ``weights``: (their
    losses, the first step's gradient norms, the change of each trained
    leaf after the last step, each step's mined seeds, each step's
    branches' scores at the seeds and foreground counts). ``seeds[s]``,
    each branch's seeds of step s (and their weights), are followed where
    given (the system's mining, checked by itself in ``mining_gap``)."""
    st = settings(tree)
    views = mapping.TrainViews(dicts, mapping_cfg(tree), st["seed"])
    t = ref.Trainer(weights, st, Precision(precision), device)
    losses, mined, look = [], [], []
    for s in range(steps):
        v = next(views)
        losses.append(t.step({k: torch.as_tensor(a, device=device) for k, a in v.items()},
                             None if seeds is None else seeds[s]))
        mined.append(t.mined)
        look.append(t.look)
    grads = ref.leaf_norms(t.grad1)
    with torch.no_grad():
        change = {k: float((t.w[k] - weights[k]).norm()) for k in grads}
    return losses, grads, change, mined, look


def seed_look(mining: List, ref_look: List, steps: int) -> List[Dict]:
    """For each refinement branch, over the compared steps: the largest
    relative gap of the system's seed weights (its scores of the seeds it
    mined) from the reference's own scores of the same seeds, and each
    step's number of foreground proposals (the reference's assignment)."""
    per_step = len(mining) // steps
    out = []
    for k in range(per_step):
        gap, fg = 0.0, []
        for s in range(steps):
            c, r = mining[s * per_step + k], ref_look[s][k]
            kept = r["kept"]
            if bool(kept.any()):
                a, b = c["weights"].float()[kept], r["scores"].float()[kept]
                gap = max(gap, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
            fg.append(r["fg"])
        out.append({"weight_gap": gap, "fg": fg})
    return out


def capture(model, cycle: int):
    """Stage 1 keeps nothing of the system's predict: its proposals are
    the benchmark's inputs."""
    return contextlib.nullcontext(None)


def kept_of_reference(out) -> None:
    return None


def reference_predict(dicts, tree: Dict, weights: Dict[str, torch.Tensor], device,
                      precision: str = "f32", proposals: Dict = None):
    """{dict index: (detections, class scores, boxes)} of the reference,
    for the test mapping of each of ``dicts`` (a {index: dict} map)."""
    st = settings(tree)
    cfg = mapping_cfg(tree)
    out = {}
    with torch.no_grad():
        for i, d in dicts.items():
            s = {k: torch.as_tensor(a, device=device)
                 for k, a in mapping.test_sample(d, cfg).items()}
            out[i] = ref.predict(s, weights, st, Precision(precision))
    return out


def check_numbers(program, refs, picks) -> Dict[str, float]:
    """The cell's numbers from the system's detections of the picked images
    (``program[i]``: (detections, None)) and the reference's."""
    from ..compare import infer_numbers

    return infer_numbers([(program[i][0], refs[i]) for i in picks])
