"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole); the plain reference imports nothing of the system."""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "sos_wsod_tpu"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not set(_imports(path)) & BANNED, path


def test_reference_imports_nothing_of_the_system():
    for path in (HERE / "reference").glob("*.py"):
        assert "sos_wsod_torch" not in set(_imports(path)), path
    code = ("import sys; import wsod_bench.reference.stage1, wsod_bench.reference.frcnn, "
            "wsod_bench.reference.mapping\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not loaded & (BANNED | {"sos_wsod_torch"}), loaded & (BANNED | {"sos_wsod_torch"})


def test_a_run_loads_no_jax():
    code = ("import json, torch; torch.set_num_threads(2)\n"
            "from wsod_bench.tests.tiny import run_tiny\n"
            "from wsod_bench.run import banned_modules\n"
            "run_tiny('oicr_plus.dump')\n"
            "print(json.dumps(banned_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
