"""The ROIAlign forward kernel's launch plan and staged walk, on the CPU.

``sos_wsod_torch/csrc/roi_align_fwd.cu`` cannot run here, so what it computes
is kept checkable in two ways:

- the launch plan (``kernels/roi_align.py:launch_plan``): channel slice,
  threads, shared memory and grid, from constants that must equal the
  source's. The shared memory is the same for every input and fits Hopper's
  227 KB a block twice over an SM; ``roi_geometry`` repeats the kernel's
  per-ROI choice of branch, and every ROI of the FPN inputs takes the staged
  one;
- an emulation of the kernel's walk in plain PyTorch (``_staged_walk``):
  each ROI's window staged from the map, the sample rows' and columns' cells
  and weight factors from ``axis_cells`` (+0 factors out of bounds instead
  of a +0 weight), the corners read from the window at the window's offsets
  (or, in the direct branch, from the map), the sums in the kernel's order.
  tests/test_torch_roi_align_walk.py holds it to the plain version
  (``roi_align_levels_reference``) bit for bit with both branches taken,
  and to the JAX ``roi_align`` within the tolerance of
  tests/test_torch_roi_align.py, at the FPN inputs: a file of its own, so
  that pytest-xdist's ``--dist loadfile`` runs it beside this one.

The emulation cannot see the .cu drift from it: the card tests
(``tests/test_torch_roi_align_cuda.py``) hold the kernel equal to the plain
version and to the earlier warp-a-bin source.
"""
from __future__ import annotations

import contextlib
import re

import numpy as np
import pytest
import torch

from sos_wsod_torch.kernels import build
from sos_wsod_torch.kernels import roi_align as kernel
from sos_wsod_torch.models.roi_heads.standard import assign_boxes_to_levels
from sos_wsod_torch.tools import bench_roi_align as bench
from sos_wsod_torch.tools.measure import ops_bound_ms

RTOL, ATOL = 1e-4, 5e-5    # tests/test_torch_roi_align.py


@contextlib.contextmanager
def _one_thread():
    """torch's CPU ops in one thread: the walk makes thousands of small ops,
    which many threads a process slow down many times over when
    pytest-xdist runs several processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@_one_thread()
def _staged_walk(feats, boxes, valid, level, scales, *, buffer_bytes=kernel.BUFFER_BYTES,
                 output_size=(7, 7), **kw):
    """What the kernel computes, branch by branch: (P, C, PH, PW) in the
    features' dtype, and the staged flags."""
    ph_out, pw_out = output_size
    g = kernel.roi_geometry([f.shape[:2] for f in feats], boxes, valid, level, scales,
                            output_size=output_size, buffer_bytes=buffer_bytes, **kw)
    cap, p, c = g["cap"], boxes.shape[0], feats[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    sizes = torch.tensor([f.shape[0] * f.shape[1] for f in feats])
    base = (torch.cumsum(sizes, 0) - sizes)[level.long()]
    w = g["w"].long()
    y = kernel.sample_positions(g["y1"], g["bin_h"], g["grid_h"], ph_out, cap)
    x = kernel.sample_positions(g["x1"], g["bin_w"], g["grid_w"], pw_out, cap)
    ylo, yhi, ly, hy = kernel.axis_cells(y, g["h"][:, None, None])
    xlo, xhi, lx, hx = kernel.axis_cells(x, g["w"][:, None, None])

    # the staged windows, (P, cells, C), row-major with the window's width
    staged = g["staged"]
    y0, _, x0, x1 = g["window"].long().unbind(1)
    ww = x1 - x0 + 1
    n = int(g["cells"][staged].max()) if staged.any() else 1
    cell = torch.arange(n)[None, :]
    src = base[:, None] + (y0[:, None] + cell // ww[:, None]) * w[:, None] + x0[:, None] \
        + cell % ww[:, None]
    inside = staged[:, None] & (cell < g["cells"][:, None])
    window = flat[torch.where(inside, src, 0)]

    def corner(yc, xc):    # (P, PH) and (P, PW) cells -> (P, PH, PW, C) values
        yc, xc = yc.long()[:, :, None], xc.long()[:, None, :]
        at = ((yc - y0[:, None, None]) * ww[:, None, None] + xc - x0[:, None, None])
        from_window = torch.gather(window, 1, at.clamp(0, n - 1).reshape(p, -1, 1)
                                   .expand(-1, -1, c)).reshape(p, ph_out, pw_out, c)
        from_map = flat[(base[:, None, None] + yc * w[:, None, None] + xc).reshape(-1)]
        return torch.where(staged[:, None, None, None], from_window,
                           from_map.reshape(p, ph_out, pw_out, c))

    acc = torch.zeros((p, ph_out, pw_out, c), dtype=torch.float32)
    for iy in range(cap):
        rows = ((ylo[:, :, iy], hy[:, :, iy, None]), (yhi[:, :, iy], ly[:, :, iy, None]))
        for ix in range(cap):
            ok = ((iy < g["grid_h"]) & (ix < g["grid_w"]))[:, None, None, None]
            cols = ((xlo[:, :, ix], hx[:, None, :, ix]), (xhi[:, :, ix], lx[:, None, :, ix]))
            s = torch.zeros_like(acc)
            for yc, wy in rows:      # the corners (lo, lo), (lo, hi), (hi, lo), (hi, hi)
                for xc, wx in cols:
                    s = s + corner(yc, xc) * (wy * wx)[..., None]
            acc = torch.where(ok, acc + s, acc)
    count = torch.clamp(g["grid_h"] * g["grid_w"], min=1).float()
    out = acc / count[:, None, None, None]
    out = torch.where(valid[:, None, None, None], out, torch.zeros_like(out))
    return out.to(feats[0].dtype).permute(0, 3, 1, 2), staged


def _fpn(dtype, c=8, **kw):
    """The benchmark's FPN inputs (its boxes are drawn after the 256-channel
    maps), cut to ``c`` channels."""
    feats, boxes, valid, level, scales = bench.fpn_inputs("cpu", dtype, 0, **kw)
    return [f[..., :c].contiguous() for f in feats], boxes, valid, level, scales


def _p2_cases(dtype):
    """The benchmark's whole-map, out-of-map and reversed ROIs on p2 alone,
    and its long ROIs on a 1344-wide canvas, cut to 8 channels."""
    cases = bench.adversarial_cases("cpu", dtype)
    cut = lambda args: ([f[..., :8].contiguous() for f in args[0]], *args[1:])
    return cut(cases["whole map p2"][0]), cut(cases["long ROIs, 1344 wide"][0])


# --- the launch plan -------------------------------------------------------

def test_constants_mirror_the_source():
    src = (build.CSRC_DIR / "roi_align_fwd.cu").read_text()
    want = {"kThreads": kernel.THREADS, "kSliceBytes": kernel.SLICE_BYTES,
            "kBufferBytes": kernel.BUFFER_BYTES, "kTable": kernel.TABLE,
            "kBlocksPerSm": kernel.BLOCKS_PER_SM, "kMaxLevels": kernel.MAX_LEVELS,
            "kSlicesPerBlock": kernel.SLICES_PER_BLOCK, "kVecBytes": kernel.VEC_BYTES}
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: got[k] for k in want} == want
    code = re.sub(r"//.*", "", src)
    assert "atomic" not in code                            # no atomics: deterministic
    assert "Axis ys[kTable];" in code and "window[kBufferBytes];" in code
    assert "int bounds[kThreads / 32][4];" in code
    assert kernel.AXIS_BYTES == 16 and "int lo, hi;\n  float l, h;" in code


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["fpn", "1344 wide", "whole map p2", "sample_cap 16",
                                  "sampling_ratio 2", "sampling_ratio 3", "C 3", "C 12"])
def test_shared_memory_fits_every_case(case, dtype):
    """The footprint is a build constant, 75,904 bytes: within the 232,448
    a block may use, three blocks an SM; a window that does not fit takes
    the direct branch, never a larger block."""
    c = {"C 3": 3, "C 12": 12}.get(case, 256)
    plan = kernel.launch_plan(c, torch.empty((), dtype=dtype).element_size(), 1000)
    assert plan["smem_bytes"] == kernel.smem_bytes() == 75904 <= kernel.SMEM_LIMIT
    assert plan["fits"] and plan["blocks_per_sm"] == kernel.BLOCKS_PER_SM == 3
    assert plan["slice"] == (64 if dtype == torch.bfloat16 else 32) and plan["threads"] == 256
    slices = -(-c // plan["slice"])
    assert plan["blocks"] == 1000 * -(-slices // kernel.SLICES_PER_BLOCK)


def test_every_fpn_roi_is_staged():
    """At the benchmark's FPN inputs every valid ROI takes the staged
    branch: 760 in 128-byte cells, 181 in 64-byte ones, 395 with two
    buffers; the largest window is 1,065 cells, the windows hold 176.6 MB
    of bf16 at 256 channels."""
    feats, boxes, valid, level, scales = _fpn(torch.bfloat16)
    g = kernel.roi_geometry([f.shape[:2] for f in feats], boxes, valid, level, scales)
    assert int(valid.sum()) == int(g["staged"].sum()) == 941
    assert not g["staged"][~valid].any()
    assert torch.bincount(g["unit"][valid] // 64).tolist() == [0, 181, 760]
    assert int(g["two_buffers"].sum()) == 395
    cells = g["cells"][valid]
    assert int(cells.max()) == 1065 and int(cells.sum()) * 256 * 2 == 176556032
    assert torch.bincount(level[valid].long()).tolist() == [560, 227, 116, 38]


@pytest.mark.parametrize("canvas,most,direct", [((704, 960), 1175, 188), ((704, 1344), 1316, 179),
                                                ((1344, 704), 1048, 0)])
def test_long_rois_at_voc_canvases(canvas, most, direct):
    """The source's footprint argument: a ROI on level k < 5 has under 784
    cells of area there, so the longest ROIs on p2-p4 have windows of at
    most 1,175 cells at the 704 x 960 canvas (1,316 at a 1344-wide one).
    Beyond the buffer's 1,152 64-byte cells lie only ROIs lying across
    nearly the whole width of p2, a few cells tall (188 and 179 of these
    1,200 lying ROIs, none standing), which take the direct branch; p5 is at
    most its whole map."""
    ih, iw = canvas[0] - 16, canvas[1] - 11
    # for p2-p4, areas just under the next level's, from square to as long
    # as the image allows, lying and standing, at fractional offsets
    area = np.repeat((224.0 * 2.0 ** np.arange(-1, 2)) ** 2 * 0.999, 400)
    long_side = np.sqrt(area) * np.exp(np.tile(np.linspace(0, 4, 400), 3))
    bw = np.minimum(long_side, iw)
    bh = np.minimum(area / bw, ih)
    bw, bh = np.concatenate([bw, np.minimum(bh, iw)]), np.concatenate([bh, np.minimum(bw, ih)])
    x1, y1 = (iw - bw) * 0.37 + 0.3, (ih - bh) * 0.61 + 0.7
    boxes = torch.from_numpy(np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32))
    feats, _, _, _, scales = bench.fpn_inputs("meta", torch.bfloat16, 0, p=1, c=1, canvas=canvas)
    level = assign_boxes_to_levels(boxes, 2, 5)
    valid = torch.ones(len(boxes), dtype=torch.bool)
    g = kernel.roi_geometry([f.shape[:2] for f in feats], boxes, valid, level, scales)
    assert int(g["cells"].max()) == most
    assert torch.equal(g["staged"], g["cells"] * 64 <= kernel.BUFFER_BYTES)
    assert int((~g["staged"]).sum()) == direct
    p5 = feats[3].shape[0] * feats[3].shape[1]
    assert p5 * 64 <= kernel.BUFFER_BYTES     # the whole of p5


def test_operations_at_the_fpn_inputs():
    """9 f32 operations for each channel of each sample of each valid ROI's
    actual grid: 383,719 samples x 256 x 9; at 67 TFLOP/s 0.0132 ms, below
    the bytes bound in bf16 (0.0161) and f32 (0.0321)."""
    feats, boxes, valid, level, scales = _fpn(torch.bfloat16)
    g = kernel.roi_geometry([f.shape[:2] for f in feats], boxes, valid, level, scales)
    ops = kernel.operations(g["grid_h"], g["grid_w"], valid, 256)
    assert ops == 884_088_576 == 383_719 * 256 * 9
    assert round(ops_bound_ms(ops), 4) == 0.0132
    for dtype, bytes_ms in ((torch.bfloat16, 0.0161), (torch.float32, 0.0321)):
        full = [torch.empty((*f.shape[:2], 256), dtype=dtype, device="meta") for f in feats]
        r = bench.bounds(full, boxes, valid, level, scales)
        assert r["ops"] == ops and r["staged"] == 941 and r["direct"] == 0
        assert round(r["bytes_bound_ms"], 4) == bytes_ms and r["bound_by"] == "bytes"
