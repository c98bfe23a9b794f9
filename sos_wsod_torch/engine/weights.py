"""Weight bridge: JAX parameter trees and d2-WSL checkpoints -> state dicts.

The port's module names mirror the JAX package's parameter tree
(``backbone.plain1.conv1``, ``roi_heads.dan.fc1``, ``roi_heads.wsddn.cls``,
``roi_heads.box_refinery_0.cls_score``, ...), so a flax tree converts leaf by
leaf: conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in). The
DAN fc1 rows stay in the (h, w, c) order the JAX tree already holds, because
the port also pools channels-last.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy or array-like leaves) -> port state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            a = np.array(value, dtype=np.float32)  # a writable copy
            if key == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            elif key == "bias":
                name = "bias"
            else:
                raise ValueError(f"unexpected leaf {'/'.join(path + (key,))}")
            out[".".join(path + (name,))] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, ())
    return out


def _fc1_channels_last(w: np.ndarray, cells: int = 49) -> np.ndarray:
    """DAN fc1 (out, C*7*7) with inputs in torch's (c, h, w) flatten order ->
    inputs in the (h, w, c) order of the channels-last pooled ROIs."""
    out_dim, in_dim = w.shape
    return w.reshape(out_dim, in_dim // cells, cells).transpose(0, 2, 1).reshape(out_dim, in_dim)


def state_dict_from_d2_wsl(blobs: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """d2-WSL checkpoint blobs (``[backbone.]plainX.convY.*``,
    ``roi_heads.box_head.fcY.*``, ``roi_heads.box_predictor.{cls,det}.*``,
    ``roi_heads.box_refinery_K.*``) -> port state dict. The layouts are
    torch's already; only fc1's inputs are reordered to channels-last. Other
    keys are skipped with a log line."""
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
