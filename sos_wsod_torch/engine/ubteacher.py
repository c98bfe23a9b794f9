"""Stage-2/3 trainers: the plain baseline trainer (stage 2) and the
Unbiased-Teacher trainer (stage 3: burn-in, then the semi-supervised step).

Counterpart of ``sos_wsod_tpu/engine/ubteacher.py`` (ubteacher's
BaselineTrainer and UBTeacherTrainer), eager PyTorch in place of jitted
steps:
  - a supervised step (``make_supervised_step``'s counterpart) stacks the
    batch's samples, runs ``GeneralizedRCNN.losses`` under bf16 autocast
    when TPU.COMPUTE_DTYPE is bfloat16 (the mean over the images of each
    loss), sums the losses into ``total_loss``, raises FloatingPointError on
    a non-finite total before its backward, then steps SGD and the LR
    schedule (``solver/build.py``);
  - the sampling draws come from a torch.Generator seeded with max(SEED, 0)
    (rank r of a process group: ``comm.derive_seed(max(SEED, 0), r)``);
  - ``UBTeacherTrainer`` keeps a ``teacher`` copy of the model, trains on
    ``label_k`` (or ``label_q + label_k`` with
    SEMISUPNET.BURN_UP_WITH_STRONG_AUG) while the iteration is below
    SEMISUPNET.BURN_UP_STEP, and from there on runs ``semisup_step``
    (``make_semisup_step``'s counterpart): the EMA of the teacher from the
    student's weights before the step's update (a full copy at
    BURN_UP_STEP), the teacher's no-grad ``predict`` on each weak unlabeled
    image, its detections thresholded into pseudo ground truth
    (``threshold_pseudo_boxes``), and one SGD step on the supervised losses
    of ``label_q + label_k`` plus UNSUP_LOSS_WEIGHT x the losses of the
    strong unlabeled images against the pseudo ground truth (the
    regression terms weighted 0);
  - ``state_dict``/``load_state_dict`` carry what a resumed run needs, the
    teacher and every rank's generator state included.
In a process group (``engine/launch.py``) the student runs under
DistributedDataParallel and the teacher does not: each rank copies its
teacher from the student before the wrap, makes the pseudo labels of its
own unlabeled images and applies the same EMA to the same weights, so the
teachers stay equal. Each loss is a per-image mean (the normalizers of
``rpn_losses`` and ``fast_rcnn_losses`` are counts of one image), and
every rank holds the same number of images, so DDP's mean over the ranks
is the global batch's loss. The logged scalars are means over the ranks.
Profiler ranges: ``h2d``, ``ema``, ``teacher``, ``backward``, ``optimizer``
and those of ``GeneralizedRCNN.losses`` and ``predict``.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch.profiler import record_function

from ..parallel import comm
from ..solver.build import build_optimizer, clip_gradients
from .trainer import DataParallelMixin, TrainerBase, seeded_generator

# the keys a step hands to the model; the rest (image_id, orig_hw, ...) is
# host-side metadata
MODEL_BATCH_KEYS = ("image", "image_hw", "gt_boxes", "gt_classes", "gt_valid", "multi_label_oh")
# the pseudo-supervised losses that enter the total with weight 0
UNWEIGHTED_PSEUDO_LOSSES = ("loss_rpn_loc", "loss_box_reg")


def filter_model_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in batch.items() if k in MODEL_BATCH_KEYS}


def stack_samples(samples: List[Dict[str, np.ndarray]], device) -> Dict[str, torch.Tensor]:
    """Mapped samples on one canvas -> their model keys stacked on ``device``."""
    keys = filter_model_batch(samples[0])
    return {k: torch.as_tensor(np.stack([s[k] for s in samples]), device=device) for k in keys}


@torch.no_grad()
def ema_update(teacher: Mapping[str, torch.Tensor], student: Mapping[str, torch.Tensor],
               keep_rate) -> None:
    """teacher = teacher x keep + student x (1 - keep), in place, over every
    floating entry of the ``teacher`` state dict (parameters and FrozenBN
    statistics alike, as ubteacher's _update_teacher_model walks its
    state_dict). keep and 1 - keep are f32 values, as in the JAX package's
    ``ema_update`` under jit; each product and the sum round to f32 on
    their own."""
    keep = torch.tensor(keep_rate, dtype=torch.float32)
    rest = float(1 - keep)
    names = [k for k, v in teacher.items() if v.is_floating_point()]
    t = [teacher[k] for k in names]
    torch._foreach_mul_(t, float(keep))
    torch._foreach_add_(t, torch._foreach_mul([student[k].to(teacher[k].dtype) for k in names],
                                              rest))


def threshold_pseudo_boxes(det_boxes: torch.Tensor, det_scores: torch.Tensor,
                           det_classes: torch.Tensor, det_valid: torch.Tensor,
                           multi_label_oh: torch.Tensor, thresh: float,
                           has_multi_label: bool) -> torch.Tensor:
    """Teacher detections -> the pseudo ground truth's validity: valid and
    score > ``thresh``; with ``has_multi_label`` the detection's class must
    also be set in the image's ``multi_label_oh`` (K,) (or (B, K) for (B,
    D) detections). A slot that is not kept by the score reads class 0, so
    a padded class never indexes."""
    keep = det_valid & (det_scores > thresh)
    if has_multi_label:
        cls = torch.where(keep, det_classes.long(), torch.zeros_like(det_classes, dtype=torch.long))
        keep = keep & multi_label_oh.bool().gather(-1, cls)
    return keep


class BaselineTrainer(DataParallelMixin, TrainerBase):
    """Stage-2 supervised trainer. ``data_iter`` yields lists of mapped
    samples on one canvas (the loader's ``label_k``); ``model`` is a
    ``GeneralizedRCNN``, and batches go to the device of its parameters."""

    def __init__(self, cfg, model, data_iter):
        super().__init__()
        self.cfg = cfg
        self.model = model.train()
        self._before_wrap(model)
        self.ddp = comm.wrap_ddp(model)
        self.data_iter = data_iter
        self.device = next(model.parameters()).device
        self.optimizer, self.scheduler = build_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.generator = seeded_generator(self.device, max(cfg.SEED, 0))
        self.steps_done = 0

    def _before_wrap(self, model) -> None:
        """What a subclass takes from the model before DDP wraps it."""

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.model.compute_dtype == torch.bfloat16)

    def _update(self, total: torch.Tensor) -> None:
        """Raise on a non-finite ``total``, else backward, clip, SGD and the
        LR schedule."""
        if not torch.isfinite(total):
            raise FloatingPointError(f"Loss became {float(total.detach())} at iteration "
                                     f"{self.iter}")
        with record_function("backward"):
            total.backward()
        with record_function("optimizer"):
            clip_gradients(self.cfg, self.params)
            self.optimizer.step()
            self.scheduler.step()
            self.optimizer.zero_grad(set_to_none=True)

    def supervised_step(self, samples: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
        """One SGD step on ``samples``; returns the mean losses and
        ``total_loss``, detached."""
        self.model.train()
        with record_function("h2d"):
            batch = stack_samples(samples, self.device)
        with self._autocast():
            losses = self.run(lambda m: m.losses(batch, self.generator))
        total = sum(v.float() for v in losses.values())
        self._update(total)
        return {**{k: v.detach() for k, v in losses.items()}, "total_loss": total.detach()}

    def _finish_step(self, data_time: float, metrics: Dict[str, torch.Tensor]) -> None:
        """Put the step's scalars (one read back from the device; means over
        the ranks in a process group) and count the step as done."""
        self.storage.put_scalar("data_time", data_time)
        keys = list(metrics)
        metrics = comm.reduce_dict(metrics)
        for k, v in zip(keys, torch.stack([metrics[k].float() for k in keys]).tolist()):
            self.storage.put_scalar(k, v)
        self.steps_done = self.iter + 1

    def run_step(self):
        t0 = time.perf_counter()
        samples = next(self.data_iter)
        data_time = time.perf_counter() - t0
        self._finish_step(data_time, self.supervised_step(samples))

    def eval_model(self):
        """The model ``--eval-only`` and the eval hook evaluate."""
        return self.model

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs; ``iter`` is the number of steps done.
        Collective in a process group: every rank calls it."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), **self.generator_states(),
                "iter": self.steps_done}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` (tensors on the model's device), with
        this rank's generator state."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.load_generator_state(state)
        self.steps_done = int(state["iter"])


class UBTeacherTrainer(BaselineTrainer):
    """Unbiased Teacher. ``data_iter`` yields the two-crop loader's batches
    {label_q, label_k, unlabel_q, unlabel_k}. Below SEMISUPNET.BURN_UP_STEP
    each step is the supervised step on label_k (label_q + label_k with
    BURN_UP_WITH_STRONG_AUG) and the teacher stays the model as built; from
    there on each step is ``semisup_step``. The teacher is evaluated when
    SEMISUPNET.EVAL_TEACHER is set."""

    def __init__(self, cfg, model, data_iter):
        super().__init__(cfg, model, data_iter)
        ss = cfg.SEMISUPNET
        self.burn_up_step = ss.BURN_UP_STEP
        self.burn_up_with_strong = ss.BURN_UP_WITH_STRONG_AUG

    def _before_wrap(self, model) -> None:
        """The teacher: a copy of the student, taken before DDP wraps it."""
        self.teacher = copy.deepcopy(model).eval().requires_grad_(False)

    def keep_rate(self) -> float:
        """The EMA's keep rate at this iteration: 0 (a full copy) at
        BURN_UP_STEP, EMA_KEEP_RATE every TEACHER_UPDATE_ITER-th step after
        it, else 1."""
        ss = self.cfg.SEMISUPNET
        if self.iter == self.burn_up_step:
            return 0.0
        if (self.iter - self.burn_up_step) % ss.TEACHER_UPDATE_ITER == 0:
            return ss.EMA_KEEP_RATE
        return 1.0

    def pseudo_labels(self, unlabel_k: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The teacher's "unsup_data_weak" pass, one image at a time, under
        no_grad: its first TEST.DETECTIONS_PER_IMAGE detections as gt_boxes,
        gt_classes and gt_valid (``threshold_pseudo_boxes``) of each image."""
        ss, cap = self.cfg.SEMISUPNET, self.cfg.TEST.DETECTIONS_PER_IMAGE
        out = {"gt_boxes": [], "gt_classes": [], "gt_valid": []}
        with torch.no_grad(), self._autocast():
            for i in range(unlabel_k["image"].shape[0]):
                det = self.teacher({"image": unlabel_k["image"][i],
                                    "image_hw": unlabel_k["image_hw"][i]},
                                   branch="unsup_data_weak")[0]
                keep = threshold_pseudo_boxes(det.boxes, det.scores, det.classes, det.valid,
                                              unlabel_k["multi_label_oh"][i],
                                              ss.BBOX_THRESHOLD, ss.HAS_MULTI_LABEL)
                out["gt_boxes"].append(det.boxes[:cap])
                out["gt_classes"].append(det.classes[:cap])
                out["gt_valid"].append(keep[:cap])
        return {k: torch.stack(v) for k, v in out.items()}

    def semisup_step(self, batch: Dict[str, List[Dict[str, np.ndarray]]]
                     ) -> Dict[str, torch.Tensor]:
        """One semi-supervised step on a two-crop batch: the EMA, the
        teacher's pseudo labels on unlabel_k, then one SGD step of the
        student on label_q + label_k and on unlabel_q against the pseudo
        labels. Returns the supervised losses, each pseudo-supervised one as
        ``<key>_pseudo``, ``total_loss`` and ``num_pseudo_boxes`` (the mean
        over the images of the kept pseudo boxes), detached."""
        self.model.train()
        with record_function("ema"):
            ema_update(self.teacher.state_dict(), self.model.state_dict(), self.keep_rate())
        with record_function("h2d"):
            label = stack_samples(batch["label_q"] + batch["label_k"], self.device)
            unlabel_q = stack_samples(batch["unlabel_q"], self.device)
            unlabel_k = stack_samples(batch["unlabel_k"], self.device)
        with record_function("teacher"):
            pseudo = self.pseudo_labels(unlabel_k)
        # both passes in one DDP forward, for the one backward of their sum
        with self._autocast():
            sup, uns = self.run(lambda m: (m.losses(label, self.generator),
                                           m.losses({**unlabel_q, **pseudo}, self.generator)))
        w = self.cfg.SEMISUPNET.UNSUP_LOSS_WEIGHT
        total = sum(v.float() for v in sup.values())
        for k, v in uns.items():
            total = total + v.float() * (0.0 if k in UNWEIGHTED_PSEUDO_LOSSES else w)
        self._update(total)
        return {**{k: v.detach() for k, v in sup.items()},
                **{f"{k}_pseudo": v.detach() for k, v in uns.items()},
                "total_loss": total.detach(),
                "num_pseudo_boxes": pseudo["gt_valid"].sum(-1).float().mean()}

    def run_step(self):
        t0 = time.perf_counter()
        batch = next(self.data_iter)
        data_time = time.perf_counter() - t0
        if self.iter < self.burn_up_step:
            metrics = self.supervised_step(batch["label_q"] + batch["label_k"]
                                           if self.burn_up_with_strong else batch["label_k"])
        else:
            metrics = self.semisup_step(batch)
        self._finish_step(data_time, metrics)

    def eval_model(self):
        return self.teacher if self.cfg.SEMISUPNET.EVAL_TEACHER else self.model

    def state_dict(self) -> Dict[str, Any]:
        return {**super().state_dict(), "teacher": self.teacher.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.teacher.load_state_dict(state["teacher"])
