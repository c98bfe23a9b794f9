"""Builds the port's CUDA sources into shared libraries with nvcc.

Each ``csrc/<name>.cu`` is compiled for Hopper (``sm_90a``) into
``build/sos_wsod_torch/lib<name>_<hash>.so`` at the root of the checkout,
where ``<hash>`` is a digest of the source, so an edited source is rebuilt and
an unchanged one is loaded as it is. The library exposes a plain C interface
and is loaded with ``ctypes``; nothing here includes PyTorch's headers, so a
build takes seconds. There is no fallback: without nvcc, ``build`` raises.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sos_wsod_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc under $CUDA_HOME (default /usr/local/cuda), else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA kernels of "
            "sos_wsod_torch need the CUDA toolkit; set CUDA_HOME")
    return found


def library_path(name: str, src=None) -> pathlib.Path:
    src = pathlib.Path(src) if src else CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, src=None) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; returns
    the library path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``<library>.log``. ``src``,
    another source with the same interface (an earlier version kept for a
    timing comparison), is for the benchmark tools; the kernels' wrappers
    build ``csrc/<name>.cu``."""
    out = library_path(name, src)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src or CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out
