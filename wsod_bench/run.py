"""Runs one cell of the benchmark once and prints one JSON line.

    python3 -m wsod_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding the system (``sos_wsod_torch``) and
this folder. Set-up makes the inputs and the weights from the seed, builds
the system, and warms up the cell's shapes; then the driver measures for
``--seconds``; then the plain reference checks what the timed path
produced. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, read from a profiled sub-window after the
measured one. The last lines on standard error, and the result's last key,
give each number compared beside its limit.

Exits 2 without a result when the card or the cell's number of cards is
missing, 3 when a module of JAX or of the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

from . import spec as specs

BANNED = ("jax", "jaxlib", "flax", "sos_wsod_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, ``overrides``
    (KEY VALUE pairs on the configuration, for tests at small sizes), and
    ``look``: whether the driver also reruns its reference to look into a
    gap (``calibrate.py --look``)."""
    cell: specs.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    overrides: List = dataclasses.field(default_factory=list)
    log: Callable[[str], None] = lambda msg: print(msg, flush=True)
    look: bool = False

    def port_cfg(self):
        """The system's configuration tree of the cell, as run."""
        from sos_wsod_torch.config import get_cfg

        cfg = get_cfg()
        _merge(cfg, self.cell.config["port_config"])
        cfg.merge_from_list(list(self.cell.config.get("overrides", [])) + list(self.overrides))
        return cfg


def _merge(node, tree: Dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict) and k in node and isinstance(node[k], dict):
            _merge(node[k], v)
        else:
            node[k] = tuple(v) if isinstance(v, list) and isinstance(node.get(k), tuple) else v


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def pin_caches(root: pathlib.Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / "build" / "wsod_bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)


def run_cell(ctx: Context) -> Dict:
    """The cell's result line (a dict), with the per-layer metrics of a
    traced run read by their readers."""
    out = ctx.cell.driver().run(ctx)
    if ctx.trace:
        metrics = {}
        for m in ctx.cell.per_layer:
            value = specs.reader(m["name"])(out["observed"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in ctx.cell.end_to_end}
    # the numbers the cell's limits name are compared; the others are shown
    checks = {k: out["numbers"][k] for k in ctx.cell.limits}
    line = {"correct": all(v <= checks_limit(ctx, k) for k, v in checks.items()),
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if ctx.trace:
        line["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": v, "limit": checks_limit(ctx, k)} for k, v in checks.items()}
    return line


def checks_limit(ctx: Context, name: str) -> float:
    return float(ctx.cell.limits[name])


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = specs.ROOT
    pin_caches(root)
    cell = specs.load(root / "BENCHMARK.json", args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    line = run_cell(ctx)
    found = banned_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
