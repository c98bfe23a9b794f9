"""The port's row gather (sos_wsod_torch/ops/gather.py) against the Pallas
row-DMA gather of tools/bench_pallas_gather.py, which runs here in interpret
mode, and against jnp.take.

A gather copies values: every comparison is exact, in bf16 and f32. The
Pallas kernel writes rows // blk blocks of blk rows, so it is compared at
multiples of blk only; the port writes every row, which the ragged cases
hold against jnp.take. The CUDA kernel is held against the plain version on
the card (tests/test_torch_gather_cuda.py).
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sos_wsod_torch.kernels.gather_rows import gather_rows_cuda
from sos_wsod_torch.ops.gather import gather_rows, gather_rows_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
_ENV = ("JAX_COMPILATION_CACHE_DIR", "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
_CONFIG = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def pallas_tool():
    """tools/bench_pallas_gather.py as a module. Importing it points JAX's
    persistent compilation cache at its own directory (environment and
    jax.config) and puts the repo root on sys.path; all of that is restored
    afterwards, so later test files on this worker are unaffected."""
    env = {k: os.environ.get(k) for k in _ENV}
    config = {k: getattr(jax.config, k) for k in _CONFIG}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("bench_pallas_gather",
                                                  ROOT / "tools" / "bench_pallas_gather.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
        yield module
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k, v in config.items():
            jax.config.update(k, v)
        sys.path[:] = path


def _inputs(table_rows, rows, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(table_rows, c).astype(np.float32),
            rng.randint(0, table_rows, rows).astype(np.int32))


@pytest.mark.parametrize("table_rows,rows,c,blk", [(1000, 256, 128, 64), (300, 96, 256, 32)])
def test_port_equals_pallas_gather(pallas_tool, table_rows, rows, c, blk):
    """bf16, exact: the Pallas kernel in interpret mode, jnp.take and the
    port on the same numpy inputs, at a multiple of blk."""
    table, idx = _inputs(table_rows, rows, c, seed=rows)
    tj = jnp.asarray(table, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_tool.make_pallas_gather(rows, c, blk, jnp.bfloat16)(tj, jnp.asarray(idx))
    assert want.shape == (rows, c) and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jnp.take(tj, idx, axis=0)))
    got = gather_rows(torch.from_numpy(table).bfloat16(), torch.from_numpy(idx), blk)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, c)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_plain_version_at_a_ragged_count(dtype, idx_dtype):
    """Every row is written at a count that is no multiple of any blk, with
    repeated indices and the first and last rows of the table."""
    table, idx = _inputs(211, 1000 - 37, 24, seed=5)
    idx[:3] = [0, 210, 0]
    want = np.take(table, idx, axis=0)
    t = torch.from_numpy(table).to(dtype)
    out = gather_rows(t, torch.from_numpy(idx).to(idx_dtype))
    assert out.dtype == dtype and out.shape == (963, 24)
    np.testing.assert_array_equal(out.float().numpy(), t.float().numpy()[idx])
    if dtype == torch.float32:
        np.testing.assert_array_equal(out.numpy(), want)
    assert gather_rows(t, torch.zeros(0, dtype=idx_dtype)).shape == (0, 24)


def test_checks_and_dispatch():
    t = torch.randn(10, 8)
    i = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        gather_rows(t[0], i)
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        gather_rows(t, i[None])
    with pytest.raises(ValueError, match="int32 or int64"):
        gather_rows(t, i.float())
    with pytest.raises(ValueError, match="no implementation"):
        gather_rows(t.to("meta"), i.to("meta"))
    # the kernel's wrapper never takes a CPU tensor: no silent plain version
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_rows_cuda(t, i)
    assert torch.equal(gather_rows_reference(t, i), t[[1, 2]])
