"""Weight bridge: JAX parameter trees and d2-WSL / detectron2 checkpoints ->
state dicts.

The port's module names mirror the JAX package's parameter tree
(``backbone.plain1.conv1``, ``roi_heads.dan.fc1``, ``roi_heads.wsddn.cls``,
``roi_heads.box_refinery_0.cls_score``, ``backbone.bottom_up.res2_block0.conv1``,
``proposal_generator.head.conv``, ``roi_heads.box_head.fc1``, ...), so a flax
tree converts leaf by leaf: conv kernels HWIO -> OIHW, Dense kernels
(in, out) -> (out, in), FrozenBN's four statistics as they are. The fc1 rows
of the DAN and of the FPN box head stay in the (h, w, c) order the JAX tree
already holds, because the port also pools channels-last; a single-view
(GeneralizedRCNNWSL) tree, whose DAN flattens NCHW ROIs in (c, h, w) order,
has its fc1 reordered (``dan_channels_last=False``), whatever the width of
its pooled ROIs (VGG16's 512 channels x 49 cells, WS-ResNet's 2048 x 49).
A single-view tree with the WS-ResNet backbone (``backbone.stem.conv1``,
``backbone.res2_block0.conv1_norm`` ...), the CSC head or any pooler
converts with no other mapping: the poolers have no weights. So do the UWSOD
trees: the RPN head (``proposal_generator.head.*``) and the MRRP backbone's
shared plain5 kernels (HWIO -> OIHW, one a conv for all branches) are
leaves like any other. Their DAN fc1 orders differ: the JAX ``UWSODRCNN``
pools NCHW, (c, h, w), the JAX ``MRRPUWSODRCNN`` channels-last, (h, w, c);
each port class names its order (``flax_dan_channels_last``). The
transposed conv of the mask head (a module named ``deconv``) has its kernel
flipped in both spatial axes, and DeformBottleneckBlock's raw
``conv2_kernel`` goes HWIO -> OIHW like a conv kernel.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def state_dict_from_flax(params: Mapping[str, Any], dan_channels_last: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy or array-like leaves) -> port state dict.
    ``dan_channels_last=False`` is for a tree whose DAN takes NCHW pooled
    ROIs flattened in (c, h, w) order (the JAX GeneralizedRCNNWSL's): its
    fc1 inputs are reordered to the port's (h, w, c)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            a = np.array(value, dtype=np.float32)  # a writable copy
            if key == "kernel" and path[-1:] == ("deconv",):
                # flax ConvTranspose (kh, kw, in, out) -> torch ConvTranspose2d
                # (in, out, kh, kw): flax's transposed conv does not flip
                # its kernel, torch's does
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                name = "weight"
            elif key == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            elif key == "conv2_kernel":   # DeformBottleneckBlock's raw HWIO kernel
                a = a.transpose(3, 2, 0, 1)
                name = key
            elif key in ("bias", "weight", "running_mean", "running_var") and a.ndim == 1:
                name = key   # a bias, or one of FrozenBN's four statistics
            else:
                raise ValueError(f"unexpected leaf {'/'.join(path + (key,))}")
            out[".".join(path + (name,))] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, ())
    fc1 = "roi_heads.dan.fc1.weight"
    if not dan_channels_last and fc1 in out:
        out[fc1] = torch.from_numpy(np.ascontiguousarray(_fc1_channels_last(out[fc1].numpy())))
    return out


def _fc1_channels_last(w: np.ndarray, cells: int = 49) -> np.ndarray:
    """DAN fc1 (out, C*7*7) with inputs in torch's (c, h, w) flatten order ->
    inputs in the (h, w, c) order of the channels-last pooled ROIs (any C)."""
    out_dim, in_dim = w.shape
    return w.reshape(out_dim, in_dim // cells, cells).transpose(0, 2, 1).reshape(out_dim, in_dim)


def state_dict_from_d2_wsl(blobs: Mapping[str, np.ndarray],
                           keep: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """d2-WSL checkpoint blobs (``[backbone.]plainX.convY.*``,
    ``roi_heads.box_head.fcY.*``, ``roi_heads.box_predictor.{cls,det}.*``,
    ``roi_heads.box_refinery_K.*``; the multi-input and the single-view
    models share these names) -> port state dict. The layouts are torch's
    already; only fc1's inputs are reordered to channels-last. Other keys are
    skipped with a log line. With ``keep`` (a model's state-dict keys), the
    converted weights the model has no place for are skipped too, with a log
    line: the box regressor of a single-view OICR branch without regression,
    the refinement branches of a WSDDN checkpoint loaded by another head."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in blobs.items():
        parts = key.split(".")
        a = np.asarray(v, np.float32)
        conv = key.removeprefix("backbone.")
        if conv.startswith("plain") and conv.count(".") == 2:
            name = "backbone." + conv
        elif key.startswith("roi_heads.box_head.fc") and len(parts) == 4:
            name = f"roi_heads.dan.{parts[2]}.{parts[3]}"
            if parts[2] == "fc1" and parts[3] == "weight" and a.shape[1] % 49 == 0:
                a = _fc1_channels_last(a)
        elif key.startswith("roi_heads.box_predictor.") and parts[2] in ("cls", "det"):
            name = f"roi_heads.wsddn.{parts[2]}.{parts[3]}"
        elif key.startswith("roi_heads.box_refinery_") and len(parts) == 4:
            name = key
        else:
            logger.info("unmatched checkpoint key: %s", key)
            continue
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    if keep is not None:
        keep = set(keep)
        for name in sorted(set(out) - keep):
            logger.info("checkpoint weight without a place in the model: %s", name)
        out = {k: v for k, v in out.items() if k in keep}
    return out


def _split_ensemble(sd: Mapping[str, Any], role: str) -> Mapping[str, Any]:
    """The ``role`` ("student" or "teacher") half of an ubteacher
    EnsembleTSModel state dict (``modelStudent.`` / ``modelTeacher.``
    prefixes); a plain state dict is the student."""
    prefix = {"student": "modelStudent.", "teacher": "modelTeacher."}[role]
    if not any(k.startswith(("modelStudent.", "modelTeacher.")) for k in sd):
        if role == "teacher":
            raise ValueError("a plain checkpoint has no teacher weights")
        return sd
    half = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not half:
        raise ValueError(f"checkpoint has no {role} weights")
    return half


def state_dict_from_d2_frcnn(sd: Mapping[str, Any], role: str = "student"
                             ) -> Dict[str, torch.Tensor]:
    """A detectron2 R50-FPN GeneralizedRCNN state dict (the reference's
    stage-2/3 checkpoints; an ubteacher ensemble gives its ``role`` half) ->
    port state dict. ``stem.conv1.norm.*`` -> ``stem.conv1_norm.*``,
    ``res2.0.conv1.*`` -> ``res2_block0.conv1.*``, ``fpn_lateral2`` ->
    ``fpn.fpn_lateral2``, ``rpn_head`` -> ``head``; box_head fc1's inputs
    are reordered to channels-last. A cascade's stage heads ``box_head.k``
    and ``box_predictor.k`` become ``box_head_k`` and ``box_predictor_k``
    (``models/roi_heads/mask_cascade.py``), the mask head's ``mask_fcn{i}``,
    ``deconv`` and ``predictor`` keep their names and layouts (the JAX
    package's bridge transposes the deconv without its spatial flip, so the
    two packages part there). pixel_mean/std and anchor buffers are
    skipped (the port's are config constants); other keys are skipped with a
    log line."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in _split_ensemble(sd, role).items():
        a = np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32)
        parts = key.split(".")
        name = None
        if key.startswith(("pixel_mean", "pixel_std")) or "anchor_generator" in key:
            continue
        if key.startswith("backbone.bottom_up.") and parts[2] == "stem":
            # stem.conv1.weight | stem.conv1.norm.X
            name = ("backbone.bottom_up.stem." +
                    ("conv1.weight" if parts[4] == "weight" and len(parts) == 5
                     else f"conv1_norm.{parts[-1]}"))
        elif key.startswith("backbone.bottom_up.res"):
            # res2.0.conv1.weight | res2.0.conv1.norm.X | res2.0.shortcut[.norm].X
            stage, block, conv = parts[2], parts[3], parts[4]
            norm = "_norm" if "norm" in parts[5:] else ""
            name = f"backbone.bottom_up.{stage}_block{block}.{conv}{norm}.{parts[-1]}"
        elif parts[0] == "backbone" and parts[1].startswith(("fpn_lateral", "fpn_output")):
            name = f"backbone.fpn.{parts[1]}.{parts[2]}"
        elif key.startswith("proposal_generator.rpn_head."):
            name = f"proposal_generator.head.{parts[2]}.{parts[3]}"
        elif key.startswith(("roi_heads.box_head.", "roi_heads.box_predictor.")):
            # box_head.fc1.weight | cascade stage k: box_head.k.fc1.weight
            head, rest = parts[1], parts[2:]
            if rest[0].isdigit():
                head, rest = f"{head}_{rest[0]}", rest[1:]
            if len(rest) == 2 and (head.startswith("box_predictor") or rest[0].startswith("fc")):
                name = f"roi_heads.{head}.{rest[0]}.{rest[1]}"
                if rest == ["fc1", "weight"] and a.shape[1] % 49 == 0:
                    a = _fc1_channels_last(a)
        elif key.startswith("roi_heads.mask_head.") and len(parts) == 4:
            name = key   # torch layouts; the deconv is a ConvTranspose2d already
        if name is None:
            logger.info("unmatched checkpoint key: %s", key)
            continue
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def load_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                 device) -> nn.Module:
    """Materialize a model built on the ``meta`` device on ``device`` and copy
    in ``state_dict`` (strict: every parameter must be given). Conv weights
    go to channels_last memory, the layout the backbone runs in. Returns the
    model in eval mode."""
    model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.to(memory_format=torch.channels_last).eval()
