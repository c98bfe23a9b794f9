"""What the ranks of a data-parallel check run, and what they report.

The functions here are started by ``engine/launch.py`` (``launch`` or
``spawn``) in every process of a group; ``tests/test_torch_ddp.py``,
``tests/test_torch_ddp_ssod.py`` and ``chip_smoke.py``'s phase 14 call them
and compare what the ranks wrote. Each rank writes ``rank<r>.pt`` (a
``torch.save`` dict) into the output directory:

  - ``train_steps(spec_path, out_dir)``: a trainer (``Stage1Trainer``,
    ``BaselineTrainer`` or ``UBTeacherTrainer``) on the rank's share of
    given global batches, from given weights; after every step the digest of
    the weights (the teacher's too) on every rank, which must agree
    (``ReplicaCheckHook``); the scalars of each step, the weights after the
    last, the sampling draws (recorded, or fed from the spec: the parity
    tests' way of giving two runs the same draws);
  - ``run_tasks(tasks, out_dir)``: the CLIs' ``main`` (stage 1, stages 2-3),
    the split tool and ``train_report`` runs, one task after another in the
    same processes, with a ``ReplicaCheckHook`` on every training run; per
    task the digests, the step times, the checkpoints this rank wrote, the
    peak memory on the card and the kernels' launches;
  - ``loader_ids(...)``: the image ids of the first batches of this rank's
    stage-1 and two-crop loaders;
  - ``repeat_world1(out_dir, steps)``: ``tools/repeat_train.py``'s stage-1
    and stage-2 runs inside a process group of one, where the trainers wrap
    the model in DistributedDataParallel.
"""
from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.hooks import HookBase
from ..parallel import comm, tensor

# the kernels' launch counters (sos_wsod_torch/kernels/*.py)
KERNEL_COUNTERS = (("roi_pool_fwd", "roi_pool", "launches"),
                   ("roi_pool_bwd", "roi_pool_bwd", "launches"),
                   ("nms", "nms", "sweep_launches"),
                   ("roi_align_fwd", "roi_align", "launches"),
                   ("roi_align_bwd", "roi_align_bwd", "launches"))


def kernel_launches() -> Dict[str, int]:
    """The kernels' launches in this process so far."""
    import importlib

    return {name: getattr(importlib.import_module(f"sos_wsod_torch.kernels.{mod}"), attr)
            for name, mod, attr in KERNEL_COUNTERS}


def state_digest(*modules: torch.nn.Module, only=None) -> str:
    """sha256 of every entry of the modules' state dicts (of those named in
    ``only``, when given), by name: equal digests are bit-identical
    weights."""
    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            if only is not None and k not in only:
                continue
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()


def card_flags() -> None:
    """The math of chip_smoke.py and repeat_train on the card: no TF32 in
    cuDNN's convolutions or cuBLAS's matmuls (a spawned rank starts with
    PyTorch's defaults)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class ReplicaCheckHook(HookBase):
    """After every step: the milliseconds of the step's ``run_step`` on this
    rank (the card synchronized before and after; the other hooks, a
    checkpoint's save among them, outside) and the kernels' launches in
    it, then the digest of the
    trainer's model (and teacher) on every rank; raises unless the ranks
    hold the same bits. Under tensor parallelism the digest is that of the
    replicated entries, which every rank must share, then ":" and that of
    the rank's shards, which the ranks of one tensor-parallel rank must
    share."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._ms, self._launches = 0.0, {}

    def before_train(self):
        run_step = self.trainer.run_step

        def timed_step():
            _sync(self.trainer.device)
            before = kernel_launches()
            t0 = time.perf_counter()
            run_step()
            _sync(self.trainer.device)
            self._ms = (time.perf_counter() - t0) * 1e3
            after = kernel_launches()
            self._launches = {k: after[k] - before[k] for k in after}

        self.trainer.run_step = timed_step

    def after_step(self):
        ms = self._ms
        modules = [self.trainer.model] + ([self.trainer.teacher]
                                          if hasattr(self.trainer, "teacher") else [])
        split = self.trainer.tp_dims
        if split:
            names = set(self.trainer.model.state_dict())
            digest = (state_digest(*modules, only=names - set(split)) + ":" +
                      state_digest(*modules, only=set(split)))
        else:
            digest = state_digest(*modules)
        digests = comm.process_gather([(tensor.rank(), digest)])
        replicated = {d.split(":")[0] for _, d in digests}
        shards = {r: {d for q, d in digests if q == r} for r, _ in digests}
        if len(replicated) != 1 or any(len(v) != 1 for v in shards.values()):
            raise AssertionError(f"iteration {self.trainer.iter}: the ranks' weights differ "
                                 f"({digests})")
        self.records.append({"iter": self.trainer.iter, "digest": digest, "ms": ms,
                             "launches": self._launches})


class SnapshotAt(HookBase):
    """After ``steps`` steps: the model's state dict in the one-process
    layout (gathered: collective) in ``state``, on the CPU."""

    def __init__(self, steps: int):
        self.steps, self.state = steps, None

    def after_step(self):
        if self.trainer.iter + 1 == self.steps:
            self.state = {k: v.detach().cpu().clone() for k, v in tensor.gather_state_dict(
                self.trainer.model.state_dict(), self.trainer.tp_dims).items()}


class TraceAt(HookBase):
    """Step ``step``'s tensor-parallel all-reduces (``tensor.traced``)."""

    def __init__(self, step: int):
        self.step, self.records, self._ctx = step, [], None

    def before_step(self):
        if self.trainer.iter == self.step:
            self._ctx = tensor.traced()
            self.records = self._ctx.__enter__()

    def after_step(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None


class SaveAt(HookBase):
    """Saves the trainer's state once, after ``steps`` steps, as
    ``model_{steps - 1:07d}`` (on every rank: the save is collective)."""

    def __init__(self, checkpointer, steps: int):
        self.checkpointer, self.steps = checkpointer, steps

    def after_step(self):
        if self.trainer.iter + 1 == self.steps:
            self.checkpointer.save(f"model_{self.trainer.iter:07d}", self.trainer.state_dict())


class DrawFeeder:
    """Stands in for ``core/sampling.py:uniform``: hands out the given
    arrays in order (their shapes must match the calls)."""

    def __init__(self, arrays: Sequence[np.ndarray]):
        self.arrays = list(arrays)

    def __call__(self, shape, generator, device):
        a = self.arrays.pop(0)
        if tuple(a.shape) != tuple(shape):
            raise AssertionError(f"a draw of shape {tuple(a.shape)} for a call of {tuple(shape)}")
        return torch.from_numpy(np.array(a, np.float32)).to(device)


class DrawRecorder:
    """Wraps ``core/sampling.py:uniform`` and keeps a copy of every draw."""

    def __init__(self, uniform):
        self.uniform, self.arrays = uniform, []

    def __call__(self, shape, generator, device):
        out = self.uniform(shape, generator, device)
        self.arrays.append(out.cpu().numpy().copy())
        return out


def _rank_share(items: list, rank: int, world: int) -> list:
    b = comm.local_batch_size(len(items), world)
    return items[rank * b:(rank + 1) * b]


def _local_batches(kind: str, batches: list, rank: int, world: int) -> list:
    """This rank's share of each global batch: a contiguous 1/world of the
    list (stage 1), of each of the two-crop batch's lists (stages 2-3)."""
    if kind == "stage1":
        return [_rank_share(b, rank, world) for b in batches]
    return [{k: _rank_share(v, rank, world) for k, v in b.items()} for b in batches]


def stage1_batches(cfg, steps: int, raw_hw, num_proposals: int, seed: int = 0) -> list:
    """``steps`` global batches of SOLVER.IMS_PER_BATCH stage-1 samples,
    the same in every process: synthetic dataset dicts through the real
    mapper and ``batched_stream`` of one process (each batch on one canvas
    per scale)."""
    from ..data.build import batched_stream
    from ..data.mapper_multi import DatasetMapperMultiInput
    from ..engine.synthetic import synthetic_train_dicts

    b = cfg.SOLVER.IMS_PER_BATCH
    dicts = synthetic_train_dicts(steps * b, raw_hw, num_proposals,
                                  cfg.MODEL.ROI_HEADS.NUM_CLASSES, seed)
    stream = batched_stream(dicts, DatasetMapperMultiInput.from_cfg(cfg), b, seed=seed,
                            size_divisibility=cfg.TPU.IMAGE_SIZE_DIVISIBILITY)
    try:
        return [next(stream) for _ in range(steps)]
    finally:
        stream.close()


def build_trainer(spec: Dict[str, Any], batches: list):
    """The spec's model (from its weights, on this rank's device) and its
    trainer over ``batches`` (see ``train_report``)."""
    from ..engine.synthetic import load_config
    from ..engine.trainer import Stage1Trainer
    from ..engine.ubteacher import BaselineTrainer, UBTeacherTrainer
    from ..engine.weights import load_weights
    from ..models.meta.rcnn import GeneralizedRCNN
    from ..models.meta.rcnn_wsl import MultiInputRCNN

    cfg = load_config(spec["config"], spec.get("opts", ()))
    kind = spec["kind"]
    if kind == "stage1":
        model = MultiInputRCNN.from_cfg(cfg, device="meta",
                                        dan_dropout=spec.get("dan_dropout", 0.5))
    else:
        model = GeneralizedRCNN.from_cfg(cfg, device="meta")
    model = load_weights(model, spec["model"], comm.local_device(cfg.MODEL.DEVICE))
    trainer_cls = {"stage1": Stage1Trainer, "baseline": BaselineTrainer,
                   "ubteacher": UBTeacherTrainer}[kind]
    data = iter([b["label_k"] for b in batches] if kind == "baseline" else batches)
    trainer = trainer_cls(cfg, model, data)
    if spec.get("teacher") is not None:
        trainer.teacher.load_state_dict(spec["teacher"])
    return model, trainer


def train_steps(spec_path: str, out_dir: str) -> None:
    """Train from the spec (a ``torch.save`` dict) and write ``rank<r>.pt``
    (``train_report``'s dict)."""
    card_flags()
    report = train_report(torch.load(spec_path, weights_only=False), out_dir)
    torch.save(report, os.path.join(out_dir, f"rank{comm.get_rank()}.pt"))


def train_report(spec: Dict[str, Any], out_dir: str) -> Dict[str, Any]:
    """Train from ``spec``: ``kind`` ("stage1", "baseline" or "ubteacher"),
    ``config`` and ``opts``, ``model`` (a state dict) and ``teacher``
    (optional), the global batches (``batches``, or ``synthetic``: the
    keyword arguments of ``stage1_batches`` but the config), ``start_iter``,
    ``dan_dropout`` (stage 1), ``tp`` (optional: the tensor-parallel size,
    ``parallel/tensor.py``; the weights reported are gathered into the
    one-process layout), ``snapshot_at`` (optional: the weights after that
    many steps, "snapshot"), ``trace_at`` (optional: that step's
    tensor-parallel all-reduces, "tp_trace"), ``draws`` (optional: per rank, the arrays to
    feed ``sampling.uniform``), ``record_draws``, ``threads`` (CPU threads),
    ``report_model`` (default True: the weights after the last step in the
    report), ``save_at`` (optional: save a checkpoint under
    ``out_dir/checkpoints`` after that many steps, ``SaveAt``),
    ``resume_at`` (optional: the same, then build a second trainer from the
    spec's weights, resume it from that checkpoint and train the remaining
    steps: its records are ``resumed``)."""
    from ..core import sampling
    from ..engine.checkpoint import Checkpointer
    from ..engine.synthetic import load_config

    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    tensor.init(spec.get("tp", 1))
    rank, world = comm.get_rank(), comm.get_world_size()
    batches = spec.get("batches")
    if batches is None:
        cfg = load_config(spec["config"], spec.get("opts", ()))
        batches = stage1_batches(cfg, **spec["synthetic"])
    batches = _local_batches(spec["kind"], batches, tensor.data_rank(), tensor.data_world_size())
    model, trainer = build_trainer(spec, batches)
    hook = ReplicaCheckHook()
    resume_at = spec.get("resume_at")
    save_at = resume_at or spec.get("save_at")
    ckpt = Checkpointer(os.path.join(out_dir, "checkpoints")) if save_at else None
    snapshot = SnapshotAt(spec["snapshot_at"]) if spec.get("snapshot_at") else None
    trace = TraceAt(spec["trace_at"]) if spec.get("trace_at") is not None else None
    trainer.register_hooks([hook] + ([SaveAt(ckpt, save_at)] if ckpt else []) +
                           [h for h in (snapshot, trace) if h is not None])
    uniform = sampling.uniform
    if spec.get("draws") is not None:
        sampling.uniform = DrawFeeder(spec["draws"][rank])
    elif spec.get("record_draws"):
        sampling.uniform = DrawRecorder(uniform)
    start = int(spec.get("start_iter", 0))
    try:
        trainer.train(start, start + len(batches))
        left = getattr(sampling.uniform, "arrays", [])
        if isinstance(sampling.uniform, DrawFeeder) and left:
            raise AssertionError(f"rank {rank}: {len(left)} draws left unused")
        draws = sampling.uniform.arrays if isinstance(sampling.uniform, DrawRecorder) else None
    finally:
        sampling.uniform = uniform
    hist = trainer.storage.histories()
    keep = spec.get("report_model", True)
    weights = tensor.gather_state_dict(model.state_dict(), trainer.tp_dims) if keep else None
    out = {"rank": rank, "world": world, "ddp": trainer.ddp is not None, "tp": tensor.size(),
           "records": hook.records, "draws": draws,
           "scalars": {k: [(it, v) for v, it in h.values()] for k, h in hist.items()},
           "model": ({k: v.cpu() for k, v in weights.items()} if keep else None),
           "snapshot": snapshot.state if snapshot else None,
           "tp_trace": trace.records if trace else None,
           "teacher": ({k: v.cpu() for k, v in trainer.teacher.state_dict().items()}
                       if keep and hasattr(trainer, "teacher") else None),
           "generator": trainer.generator.get_state()}
    if ckpt:
        out["saved"] = list(ckpt.saved)
    if resume_at:
        _, again = build_trainer(spec, batches[resume_at:])
        at = Checkpointer(ckpt.output_dir).resume_or_load(again)
        again_hook = ReplicaCheckHook()
        again.register_hooks([again_hook])
        again.train(at, start + len(batches))
        out["resumed"] = {"start": at, "records": again_hook.records,
                          "generator": again.generator.get_state()}
    return out


def loader_ids(out_dir: str, num_images: int, stage1_batch: int, label_batch: int,
               unlabel_batch: int, num_batches: int, seed: int = 0) -> None:
    """The image ids of the first ``num_batches`` batches of this rank's
    stage-1 loader (``build_stage1_train_loader`` over a registered dataset
    of ``num_images`` ids, SOLVER.IMS_PER_BATCH ``stage1_batch``) and of its
    two-crop loader (the first half labeled, global batches of
    ``label_batch`` + ``unlabel_batch``), and the modules of JAX or the JAX
    package this process holds (none); writes ``rank<r>.pt``."""
    from ..config import get_cfg
    from ..data.build import build_stage1_train_loader
    from ..data.catalog import DatasetCatalog
    from ..data.mapper_twocrop import build_semisup_two_crop_loader

    rank, world = comm.get_rank(), comm.get_world_size()
    dicts = [{"image_id": 100 + i, "annotations": [{"bbox": [0, 0, 1, 1], "category_id": 0}]}
             for i in range(num_images)]
    name = "check_ddp_ids"
    if name not in DatasetCatalog:
        DatasetCatalog.register(name, lambda: dicts)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "MultiInputRCNN", "DATASETS.TRAIN",
                         (name,), "SOLVER.IMS_PER_BATCH", stage1_batch,
                         "DATALOADER.NUM_WORKERS", 0, "SEED", seed])

    def one_view(d):
        canvas = np.zeros((2, 8, 8, 3), np.float32)
        return {"images_s1": canvas, "images_s2": canvas, "prop_valid": np.ones(4, bool),
                "image_id": d["image_id"]}

    def two_crop(d):
        s = {"image": np.zeros((8, 8, 3), np.float32), "image_id": d["image_id"]}
        return s, dict(s)

    stream = build_stage1_train_loader(cfg, mapper=one_view)
    stage1 = [[s["image_id"] for s in next(stream)] for _ in range(num_batches)]
    half = num_images // 2
    two = build_semisup_two_crop_loader(dicts[:half], dicts[half:], two_crop,
                                        label_batch // world, unlabel_batch // world, seed=seed,
                                        rank=rank, world=world)
    semisup = []
    for _ in range(num_batches):
        b = next(two)
        semisup.append({k: [s["image_id"] for s in v] for k, v in b.items()})
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "sos_wsod_tpu"))
    torch.save({"stage1": stage1, "semisup": semisup, "foreign_modules": foreign},
               os.path.join(out_dir, f"rank{rank}.pt"))


def _cli_main(cli: str):
    from . import splits, train_net_stage1, train_net_unbias

    return {"stage1": train_net_stage1.main, "unbias": train_net_unbias.main,
            "splits": splits.main}[cli]


def run_tasks(tasks: Sequence[Dict[str, Any]], out_dir: str, cwd: Optional[str] = None,
              threads: int = 0) -> None:
    """Run each task in ``cwd``: {"name", "cli": "stage1" | "unbias" |
    "splits", "argv"} (optionally "marker": a checkpoint name written into
    "output_dir"'s ``last_checkpoint`` by rank 0 before the task, to resume
    from it), {"name", "cli": "steps", "spec": a ``train_report`` spec's
    file, "out_dir"}, or {"name", "cli": "allreduce", "numel": [...],
    "device"} (``allreduce_ms``). Writes ``rank<r>.pt``: each task's replica records,
    the checkpoints this rank wrote, its kernel launches, its seconds, its
    peak memory on the card and, for the split, the split (for "steps",
    ``train_report``'s dict)."""
    from ..engine.defaults import default_argument_parser
    from ..engine.hooks import CheckpointHook

    if threads:
        torch.set_num_threads(threads)
    card_flags()
    if cwd:
        os.chdir(cwd)
    rank = comm.get_rank()
    report = []
    for task in tasks:
        if task.get("marker") and comm.is_main_process():
            with open(os.path.join(task["output_dir"], "last_checkpoint"), "w") as f:
                f.write(task["marker"])
        comm.synchronize()
        tensor.init(1)
        before = kernel_launches()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        entry: Dict[str, Any] = {"name": task["name"]}
        if task["cli"] == "splits":
            entry["split"] = _cli_main("splits")(task["argv"])[0]
        elif task["cli"] == "allreduce":
            entry["allreduce_ms"] = allreduce_ms(task["numel"], task.get("device", "cuda"),
                                                 task.get("repeats", 3))
        elif task["cli"] == "steps":
            entry.update(train_report(torch.load(task["spec"], weights_only=False),
                                      task["out_dir"]))
        else:
            hook = ReplicaCheckHook()
            args = default_argument_parser().parse_args(task["argv"])
            trainer = _cli_main(task["cli"])(args, hooks=[hook])
            entry["records"] = hook.records
            entry["saved"] = [name for h in trainer._hooks if isinstance(h, CheckpointHook)
                              for name in h.checkpointer.saved]
            entry["ddp"] = trainer.ddp is not None
            entry["generator"] = trainer.generator.get_state()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            entry["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        entry["secs"] = time.perf_counter() - t0
        after = kernel_launches()
        entry["launches"] = {k: after[k] - before[k] for k in after}
        report.append(entry)
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))


def allreduce_ms(numels: Sequence[int], device: str = "cuda", repeats: int = 3
                 ) -> Dict[int, float]:
    """The median milliseconds of one all-reduce (sum) of ``n`` f32 on this
    rank's device, for each ``n`` of ``numels``: the ranks meet at a
    barrier, the card synchronized, then the all-reduce and a synchronize
    on the clock. One warm-up call each."""
    device = comm.local_device(device)
    out = {}
    for n in numels:
        x = torch.ones(int(n), dtype=torch.float32, device=device)
        times = []
        for i in range(repeats + 1):
            comm.synchronize()
            _sync(device)
            t0 = time.perf_counter()
            torch.distributed.all_reduce(x)
            _sync(device)
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[int(n)] = float(np.median(times))
        del x
    return out


def repeat_world1(out_dir: str, steps: int = 2, device: str = "cuda",
                  stage1: Optional[Dict[str, Any]] = None,
                  stage2: Optional[Dict[str, Any]] = None) -> None:
    """``repeat_train``'s stage-1 and stage-2 runs of ``steps`` steps
    (``train_once`` and ``train_stage2_once`` with the keyword arguments
    ``stage1`` and ``stage2``: smaller widths for a run on the CPU) in this
    process's group, of one on the card, where the trainers wrap their
    models in DistributedDataParallel. Writes ``rank<r>.pt`` with both
    results (each says whether its trainer was wrapped), the backend and
    the kernels' launches."""
    from . import repeat_train

    card_flags()
    device = comm.local_device(device)
    out = {"world": comm.get_world_size(), "backend": str(torch.distributed.get_backend()),
           "stage1": repeat_train.train_once(device, steps, **(stage1 or {})),
           "stage2": repeat_train.train_stage2_once(device, steps, **(stage2 or {})),
           "launches": kernel_launches()}
    torch.save(out, os.path.join(out_dir, f"rank{comm.get_rank()}.pt"))


def load_reports(out_dir: str, world: int) -> List[Any]:
    """Every rank's ``rank<r>.pt``, by rank."""
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
