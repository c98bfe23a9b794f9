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

The pretrained-weight readers (counterparts of the JAX package's
``load_pkl``, ``resnet_c2_param_tree``, ``merge_pretrained`` and the
``load_*`` functions): a d2 or caffe2 ``.pkl`` (``load_pkl``), caffe2's
ImageNet R-50 blobs (``state_dict_from_c2_resnet``), a torchvision VGG16
(``state_dict_from_torchvision_vgg16``) and a released stage-1 ``.pth``
with d2-WSL names become port state dicts, and ``load_pretrained``
overwrites the entries of a built model that they name, shape-checked,
leaving the others as initialised.
"""
from __future__ import annotations

import logging
import pickle
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


def load_pkl(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a detectron2 or caffe2 ``.pkl`` (latin-1 pickles of
    numpy blobs, under "model" when it is there)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data.get("model", data)
    return {k: np.asarray(v) for k, v in blobs.items()
            if isinstance(v, np.ndarray) or hasattr(v, "shape")}


_C2_BRANCH = {"branch1": "shortcut", "branch2a": "conv1", "branch2b": "conv2",
              "branch2c": "conv3"}


def state_dict_from_c2_resnet(blobs: Mapping[str, np.ndarray],
                              prefix: str = "backbone.bottom_up.") -> Dict[str, torch.Tensor]:
    """caffe2 ImageNet ResNet blobs (``conv1_w``, ``res_conv1_bn_{s,b}``,
    ``res{s}_{b}_branch{1,2a,2b,2c}_{w,bn_s,bn_b}``) -> the stage-2
    backbone's ``bottom_up`` entries (``stem.conv1``, ``res{s}_block{b}.
    {shortcut,conv1,conv2,conv3}`` and their ``_norm``). The convs keep
    torch's OIHW; an affine BN becomes FrozenBN weight ``s`` and bias ``b``
    with mean 0 and variance 1 (caffe2 folds the statistics into them).
    Other blobs (the classifier, momenta) are left out."""
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, a) -> None:
        out[prefix + name] = torch.from_numpy(np.array(a, np.float32))

    def put_norm(name: str, scale, shift) -> None:
        put(f"{name}.weight", scale)
        put(f"{name}.bias", shift)
        put(f"{name}.running_mean", np.zeros_like(shift))
        put(f"{name}.running_var", np.ones_like(scale))

    if "conv1_w" in blobs:
        put("stem.conv1.weight", blobs["conv1_w"])
        put_norm("stem.conv1_norm", blobs["res_conv1_bn_s"], blobs["res_conv1_bn_b"])
    for key, v in blobs.items():
        parts = key.split("_")
        if not key.startswith("res") or key.startswith("res_conv1") or len(parts) < 4:
            continue
        stage, block, branch, rest = parts[0], parts[1], parts[2], "_".join(parts[3:])
        conv = _C2_BRANCH.get(branch)
        if conv is None:
            continue
        mod = f"{stage}_block{block}"
        if rest == "w":
            put(f"{mod}.{conv}.weight", v)
        elif rest == "bn_s":
            put_norm(f"{mod}.{conv}_norm", v, blobs[key[:-1] + "b"])
    return out


# torchvision vgg16's ``features`` conv indices, stage by stage
_TV_VGG16_LAYOUT = (("plain1", (0, 2)), ("plain2", (5, 7)), ("plain3", (10, 12, 14)),
                    ("plain4", (17, 19, 21)), ("plain5", (24, 26, 28)))


def state_dict_from_torchvision_vgg16(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state dict (``features.N.*``, ``classifier.
    {0,3}.*``) -> the VGG16 backbone's ``backbone.plainX.convY`` and the
    DAN's fc1 (inputs reordered to channels-last) and fc2. torchvision's
    weights expect RGB / 255 normalised input, the reference's caffe
    weights BGR minus the mean: the preprocessing is not converted."""
    def arr(key):
        v = sd.get(key)
        if v is None:
            return None
        return np.array(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32)

    out: Dict[str, torch.Tensor] = {}
    for stage, idxs in _TV_VGG16_LAYOUT:
        for j, li in enumerate(idxs, start=1):
            w, b = arr(f"features.{li}.weight"), arr(f"features.{li}.bias")
            if w is None:
                logger.info("missing torchvision key features.%d.weight", li)
                continue
            out[f"backbone.{stage}.conv{j}.weight"] = torch.from_numpy(w)
            if b is not None:
                out[f"backbone.{stage}.conv{j}.bias"] = torch.from_numpy(b)
    for j, li in enumerate((0, 3), start=1):
        w, b = arr(f"classifier.{li}.weight"), arr(f"classifier.{li}.bias")
        if w is not None:
            if j == 1 and w.shape[1] % 49 == 0:
                w = _fc1_channels_last(w)
            out[f"roi_heads.dan.fc{j}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        if b is not None:
            out[f"roi_heads.dan.fc{j}.bias"] = torch.from_numpy(b)
    return out


def load_pretrained(model: nn.Module, pretrained: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy the entries of ``pretrained`` into ``model``'s parameters and
    buffers of the same name, in place, and return the model; every other
    entry keeps its initialised value. Every shape is checked before any
    copy: a mismatch raises ValueError with the name and both shapes. The
    names of ``pretrained`` the model lacks are logged."""
    own = model.state_dict()
    for name, v in pretrained.items():
        if name in own and tuple(v.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch at {name}: pretrained {tuple(v.shape)} vs "
                             f"model {tuple(own[name].shape)}")
    unmatched = sorted(set(pretrained) - set(own))
    if unmatched:
        logger.info("pretrained weights the model has no place for: %s", ", ".join(unmatched))
    with torch.no_grad():
        for name, v in pretrained.items():
            if name in own:
                own[name].copy_(v)
    logger.info("loaded %d of the model's %d entries", len(set(pretrained) & set(own)), len(own))
    return model


def load_vgg_wsl_weights(model: nn.Module, path: str) -> nn.Module:
    """A d2-WSL VGG16 ``.pkl`` (VGG_ILSVRC_16_layers_v1_d2.pkl, a stage-1
    checkpoint's blobs) into a stage-1 model."""
    return load_pretrained(model, state_dict_from_d2_wsl(load_pkl(path)))


def load_resnet_imagenet_weights(model: nn.Module, path: str) -> nn.Module:
    """caffe2's ImageNet R-50.pkl into a stage-2 GeneralizedRCNN's
    ``backbone.bottom_up``."""
    return load_pretrained(model, state_dict_from_c2_resnet(load_pkl(path)))


def load_vgg_wsl_torch_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """A released stage-1 OICR+ ``.pth`` with d2-WSL names (the state dict
    itself, or under "model" or "state_dict") into a stage-1 model."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        inner = ckpt.get(key) if isinstance(ckpt, dict) else None
        if isinstance(inner, dict) and any(torch.is_tensor(v) for v in inner.values()):
            ckpt = inner
            break
    blobs = {k: v.float().numpy() for k, v in ckpt.items() if torch.is_tensor(v)}
    return load_pretrained(model, state_dict_from_d2_wsl(blobs))
