"""The ROIAlign forward kernel's staged walk at the FPN inputs, on the CPU.

The emulation of ``sos_wsod_torch/csrc/roi_align_fwd.cu``'s walk
(``_staged_walk`` in tests/test_torch_roi_align_plan.py, with its inputs)
must equal the plain version (``roi_align_levels_reference``) bit for bit
with both branches taken, and the JAX ``roi_align`` within the tolerance of
tests/test_torch_roi_align.py. These runs at the full FPN inputs take most
of the two files' time, so they are a file of their own: pytest-xdist's
``--dist loadfile`` gives each file to one worker. They run torch in one
thread, as the walk does.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.models.roi_heads.standard import multilevel_roi_align as jax_multilevel
from sos_wsod_tpu.ops.roi_align import roi_align as jax_roi_align
from sos_wsod_torch.kernels import roi_align as kernel
from sos_wsod_torch.ops.roi_align import roi_align_levels_reference
from sos_wsod_torch.tools import bench_roi_align as bench
from test_torch_roi_align_plan import ATOL, RTOL, _fpn, _one_thread, _p2_cases, _staged_walk


@pytest.fixture(autouse=True)
def _in_one_thread():
    """The plain version's thousands of small ops too (see ``_one_thread``)."""
    with _one_thread():
        yield


# --- the staged walk against the plain version and JAX ---------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_walk_equals_plain_at_the_fpn_inputs(dtype):
    args = _fpn(dtype)
    got, staged = _staged_walk(*args)
    assert bool(staged[args[2]].all())
    assert torch.equal(got, roi_align_levels_reference(*args))


@pytest.mark.parametrize("kw,buffer_bytes", [({}, 19200), ({"sample_cap": 16}, kernel.BUFFER_BYTES),
                                             ({"sampling_ratio": 2}, 19200),
                                             ({"sampling_ratio": 3}, 25600),
                                             ({"sampling_ratio": 20}, kernel.BUFFER_BYTES),
                                             ({"aligned": False}, 25600)])
def test_walk_takes_both_branches(kw, buffer_bytes):
    """Smaller buffers (and, with a cap of 16 or a fixed ratio of 20, the
    tables) force the direct branch on part of the ROIs: both branches equal
    the plain version."""
    args = _fpn(torch.float32, p=120 if kw.get("sampling_ratio") == 20 else 400)
    got, staged = _staged_walk(*args, buffer_bytes=buffer_bytes, **kw)
    n_staged, n_valid = int(staged.sum()), int(args[2].sum())
    if kw.get("sampling_ratio") == 20:
        assert n_staged == 0                  # 7 x 20 sample rows overflow the tables
    else:
        assert 0 < n_staged < n_valid
    assert torch.equal(got, roi_align_levels_reference(*args, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_walk_on_whole_map_and_long_rois(dtype):
    """Whole-map, out-of-map and reversed ROIs on p2, and long thin ROIs on
    a 1344-wide canvas: the direct branch for the windows beyond the
    buffer, the staged one for the rest."""
    for args in _p2_cases(dtype):
        got, staged = _staged_walk(*args)
        assert 0 < int(staged.sum()) < int(args[2].sum())
        assert torch.equal(got, roi_align_levels_reference(*args))


def test_walk_matches_jax_on_one_level():
    """Against the JAX package on p2 alone, whole-map ROIs included, through
    both branches, in the FPN head's mode. (With a fixed ratio of 2 these
    ROIs take the plain version itself up to 7.9e-5 from JAX, past the
    tolerance: XLA:CPU's FMAs move the positions of the few-sample bins of
    long ROIs; fixed ratios are held on the multi-level inputs below.)"""
    aligned, sampling = True, 0
    p2, _ = _p2_cases(torch.float32)
    feats, boxes, valid, level, scales = p2
    got, staged = _staged_walk(feats, boxes, valid, level, scales, buffer_bytes=400 * 64,
                               sampling_ratio=sampling, aligned=aligned)
    assert 0 < int(staged.sum()) < len(staged)
    want = jax_roi_align(jnp.asarray(feats[0].numpy()), jnp.asarray(boxes.numpy()),
                         jnp.asarray(valid.numpy()), spatial_scale=scales[0],
                         sampling_ratio=sampling, aligned=aligned)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aligned,sampling", [(True, 0), (False, 2)])
def test_walk_matches_jax_multilevel(aligned, sampling):
    """Against the JAX multi-level layout, as tests/test_torch_roi_align.py
    holds the plain version."""
    feats, boxes, valid, level, scales = _fpn(torch.float32, p=200)
    got, staged = _staged_walk(feats, boxes, valid, level, scales, sampling_ratio=sampling,
                               aligned=aligned)
    assert bool(staged[valid].all())
    want = jax_multilevel([jnp.asarray(f.numpy()) for f in feats], bench.STRIDES,
                          jnp.asarray(boxes.numpy()), jnp.asarray(valid.numpy()),
                          sampling_ratio=sampling, aligned=aligned)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
