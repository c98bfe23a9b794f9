"""Teacher/student checkpoint surgery (ensemble <-> plain model).

Counterpart of ``sos_wsod_tpu/tools/convert_checkpoints.py`` (the reference's
tools/convert2detectron2.py and tools/convert2unbias.py) on the port's
``torch.save`` checkpoints (``engine/checkpoint.py``): the ensemble layout
is {"model" (the student), "teacher", ...}, a plain layout {"model"}. Each
file written becomes its directory's ``last_checkpoint``.

    python -m sos_wsod_torch.tools.convert_checkpoints [convert2detectron2] \\
        SOURCE TARGET [--mode teacher|student]
    python -m sos_wsod_torch.tools.convert_checkpoints convert2unbias SOURCE TARGET
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from ..engine.checkpoint import Checkpointer


def _load(path: str):
    return Checkpointer(os.path.dirname(path) or ".").load(os.path.basename(path),
                                                            map_location="cpu")


def _save(path: str, state) -> None:
    Checkpointer(os.path.dirname(path) or ".").save(os.path.basename(path), state)


def convert2detectron2(source_path: str, target_path: str, mode: str = "teacher") -> None:
    """Extract one role of an ensemble checkpoint -> plain {"model": ...}."""
    state = _load(source_path)
    key = "teacher" if mode == "teacher" else "model"
    if key not in state:
        raise KeyError(f"checkpoint has no '{key}' (keys: {list(state)})")
    _save(target_path, {"model": state[key]})


def convert2unbias(source_path: str, target_path: str) -> None:
    """Duplicate a plain model into the student ("model") and teacher roles."""
    state = _load(source_path)
    model = state.get("model", state)
    _save(target_path, {"model": model, "teacher": {k: v.clone() for k, v in model.items()}})


def main_convert2detectron2(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="convert the unbiased model to a plain model.")
    p.add_argument("source_path")
    p.add_argument("target_path")
    p.add_argument("--mode", "-m", choices=["teacher", "student"], default="teacher")
    a = p.parse_args(argv)
    convert2detectron2(a.source_path, a.target_path, a.mode)


def main_convert2unbias(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="convert a plain model to the ensemble layout.")
    p.add_argument("source_path")
    p.add_argument("target_path")
    a = p.parse_args(argv)
    convert2unbias(a.source_path, a.target_path)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``convert2unbias ...`` or ``[convert2detectron2] ...``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["convert2unbias"]:
        return main_convert2unbias(argv[1:])
    return main_convert2detectron2(argv[1:] if argv[:1] == ["convert2detectron2"] else argv)


if __name__ == "__main__":
    main()
