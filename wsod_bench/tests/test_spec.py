"""BENCHMARK.json against the contract's shape, and the harness finding
every part of a cell by name; a new cell, configuration, traffic mix and
per-layer metric added as files and entries only."""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from wsod_bench import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word


def test_names_units_and_metrics():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    texts = [x["why"] for key in ("configs", "workloads") for x in BENCH[key]] + \
        [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", [])) <= set(CELLS)
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = spec.load(ROOT / "BENCHMARK.json", cell)
    assert hasattr(c.driver(), "run") and hasattr(c.model(), "reference_predict")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer, cell
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())


def test_every_config_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and set(c["reduced"]) == set(data["reduced"])


def test_new_cell_config_mix_and_metric_by_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell as new files and new entries; the cell then
    runs (at a tiny size on the CPU) and reports the new metric."""
    work = tmp_path / "checkout"
    work.mkdir()
    shutil.copytree(ROOT / "wsod_bench", work / "wsod_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "wsod_bench/configs/voc07_oicr_plus.json").read_text())
    config["name"] = "voc07_oicr_plus_k2"
    config["port_config"]["WSL"]["REFINE_NUM"] = 2
    config["port_config"]["WSL"]["REFINE_REG"] = [True, True]
    (work / "wsod_bench/configs/voc07_oicr_plus_k2.json").write_text(json.dumps(config))
    mix = json.loads((ROOT / "wsod_bench/traffic/test_stream.json").read_text())
    mix["raw_share"] = [1.0, 0.0, 0.0]
    (work / "wsod_bench/traffic/test_stream_landscape.json").write_text(json.dumps(mix))
    (work / "wsod_bench/metrics/images_traced.infer.py").write_text(
        "def read(obs):\n    return float(obs.trace.units)\n")
    (work / "wsod_bench/limits/k2.dump.json").write_text(
        (ROOT / "wsod_bench/limits/oicr_plus.dump.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "voc07_oicr_plus_k2",
                             "file": "wsod_bench/configs/voc07_oicr_plus_k2.json"})
    bench["workloads"].append({"name": "k2.dump", "config": "voc07_oicr_plus_k2",
                               "traffic": "test_stream_landscape", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "images_traced.infer", "unit": "img", "better": "higher",
                               "source": "program_counter", "layer": "inference driver",
                               "moves": "infer_img_per_s", "workloads": ["k2.dump"]})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_img_per_s":
            m["workloads"].append("k2.dump")
    (work / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, torch; torch.set_num_threads(2)\n"
            "from wsod_bench.tests.tiny import run_tiny\n"
            "print(json.dumps(run_tiny('k2.dump', trace=True)))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(work), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], cwd=work, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["images_traced.infer"]["value"] > 0
    assert not (pathlib.Path(ROOT) / "wsod_bench/traffic/test_stream_landscape.json").exists()
