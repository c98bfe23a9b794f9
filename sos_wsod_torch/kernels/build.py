"""Builds the port's native sources into shared libraries: the CUDA
kernels with nvcc, the host C++ with g++.

Each ``csrc/<name>.cu`` is compiled for Hopper (``sm_90a``) into
``build/sos_wsod_torch/lib<name>_<hash>.so`` at the root of the checkout,
where ``<hash>`` is a digest of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Each ``native/<name>.cpp``
(the dense CRF) is host code, built the same way by ``build_host`` with g++
and the JAX package's flags for it. A library exposes a plain C interface and
is loaded with ``ctypes``; nothing here includes PyTorch's headers, so a build
takes seconds. There is no fallback: without nvcc, ``build`` raises, and
without g++, ``build_host``.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
NATIVE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sos_wsod_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


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


def library_path(name: str, src=None, flags=NVCC_FLAGS) -> pathlib.Path:
    src = pathlib.Path(src) if src else CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(cmd, name: str, out: pathlib.Path) -> None:
    """Run ``cmd`` (which writes its library to ``out``'s temporary name)
    and move the library into place; the compiler's report goes beside it
    as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{pathlib.Path(cmd[0]).name} failed ({proc.returncode}) building {name}:\n"
            f"{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file


def build(name: str, src=None) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists; returns
    the library path. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``<library>.log``. ``src``,
    another source with the same interface (an earlier version kept for a
    timing comparison), is for the benchmark tools; the kernels' wrappers
    build ``csrc/<name>.cu``."""
    out = library_path(name, src)
    if not out.is_file():
        _compile([find_nvcc(), *NVCC_FLAGS, str(src or CSRC_DIR / f"{name}.cu")], name, out)
    return out


def build_host(name: str) -> pathlib.Path:
    """Compile the host source ``native/<name>.cpp`` with g++ (HOST_FLAGS)
    unless its library already exists; returns the library path."""
    src = NATIVE_DIR / f"{name}.cpp"
    out = library_path(name, src, HOST_FLAGS)
    if not out.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found on PATH: {src.name} of sos_wsod_torch is host "
                               "C++ built at first use")
        _compile([gxx, *HOST_FLAGS, str(src)], name, out)
    return out
