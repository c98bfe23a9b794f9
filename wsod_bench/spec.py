"""Finds a cell's parts by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration (its ``file``,
JSON: the system's configuration tree as run, the weights' init rules, the
model family) and a traffic mix (``traffic/<name>.json``: the parameters
of the synthetic inputs and the driver, ``drivers/<driver>.py``, that runs
its window). A model family is ``models/<model>.py``, a per-layer metric
``metrics/<name>.py`` (a reader), the limits of a cell's comparison
``limits/<cell>.json``. Adding a cell, a configuration, a mix or a metric
adds files and entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration's file
    traffic: Dict         # the mix's file
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]

    def model(self):
        return importlib.import_module(f"wsod_bench.models.{self.config['model']}")

    def driver(self):
        return importlib.import_module(f"wsod_bench.drivers.{self.traffic['driver']}")


def load(benchmark: pathlib.Path, workload: str) -> Cell:
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((benchmark.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer, limits)


def reader(metric: str):
    """The ``read(observed)`` function of a per-layer metric's reader."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"wsod_bench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
