"""The ROIAlign backward kernel's launch plan and tiled walk, on the CPU.

``sos_wsod_torch/csrc/roi_align_bwd.cu`` cannot run here, so what it computes
is kept checkable in three ways:

- the plain backward (``ops/roi_align.py:roi_align_levels_backward_reference``)
  fixes the order and arithmetic: per bin gc = g / count, Y[y] and X[x] the
  sums of the sample rows' and columns' factors by cell, one term (gc * Y) *
  X a cell, each cell's terms added in (p, ph, pw) order. Here it is held to
  an f32 ``np.add.at`` of the same terms, which adds in order;
- the launch plan (``kernels/roi_align_bwd.py:launch_plan``): tile, channel
  slice, threads, shared memory and grid, from constants that must equal the
  source's; the shared memory does not depend on the inputs and fits a block
  up to the largest training canvas;
- an emulation of the kernel's walk in plain PyTorch (``_tiled_walk``): for
  every tile of every level, the ROIs whose extreme samples meet it, passes
  of 32 / (PH + PW) of them in bounded queues, each bin's row and column
  tables in the tile (sums in the kernel's order), the bins whose two tables
  are not empty in (p, ph, pw) order, and each lane's adds in queue order in
  f32 with one rounding for each product and each add. It must equal the
  plain backward bit for bit, through several tile sizes, ragged map edges,
  invalid ROIs, V1, a sample cap of 16, a fixed ratio of 20 and the mask
  head's 14 x 14 bins, in both dtypes.

The emulation cannot see the .cu drift from it: the card tests
(``tests/test_torch_roi_align_bwd_cuda.py``) hold the kernel bit-identical
to the plain backward run on the CPU, and to itself across launches.
"""
from __future__ import annotations

import itertools
import re

import numpy as np
import pytest
import torch

from sos_wsod_torch.kernels import build
from sos_wsod_torch.kernels import roi_align as fwd_kernel
from sos_wsod_torch.kernels import roi_align_bwd as kernel
from sos_wsod_torch.models.roi_heads.standard import assign_boxes_to_levels
from sos_wsod_torch.ops.roi_align import backward_terms, roi_align_levels_backward_reference
from sos_wsod_torch.tools import bench_roi_align as bench
from sos_wsod_torch.tools.measure import bound_ms

TRAIN_SHAPES = {(704, 960): [(176, 240), (88, 120), (44, 60), (22, 30)],
                (1216, 1664): [(304, 416), (152, 208), (76, 104), (38, 52)]}


# --- the launch plan -------------------------------------------------------

def test_constants_mirror_the_source():
    src = (build.CSRC_DIR / "roi_align_bwd.cu").read_text()
    want = {"kTileH": kernel.TILE_H, "kTileW": kernel.TILE_W, "kVec": kernel.VEC,
            "kDepth": kernel.DEPTH, "kQueue": kernel.QUEUE, "kTables": kernel.TABLES,
            "kRois": kernel.ROIS, "kMaxBins": kernel.MAX_BINS, "kMaxCap": kernel.MAX_CAP,
            "kMaxLevels": fwd_kernel.MAX_LEVELS}
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: got[k] for k in want} == want
    assert "kMinBlocks = 864 / kThreads;" in src and kernel.MIN_BLOCKS == 3
    code = re.sub(r"//.*", "", src)
    assert "atomic" not in code and "Memset" not in code     # no atomics, no zeroed buffer
    assert code.count("__global__") == 1                      # no cast kernel
    assert "kThreads = kTileH * 32 + 32" in code and "__fmaf" not in code and "fmaf(" not in code
    wrapper = (build.PACKAGE_DIR / "kernels" / "roi_align_bwd.py").read_text()
    assert "torch.zeros" not in wrapper and "from ..ops" not in wrapper   # no fallback


@pytest.mark.parametrize("canvas", sorted(TRAIN_SHAPES))
@pytest.mark.parametrize("c", [3, 12, 256])
def test_launch_plan_up_to_the_largest_training_canvas(canvas, c):
    """One block for each tile of each level and each slice of 128
    channels (32 where the channels are not a multiple of 4); the same
    shared memory for every input, within the 232,448 bytes a block may
    use, three blocks an SM; a warp for each tile row and the filling
    warp."""
    shapes = TRAIN_SHAPES[canvas]
    plan = kernel.launch_plan(shapes, c)
    tiles = sum(-(-h // kernel.TILE_H) * -(-w // kernel.TILE_W) for h, w in shapes)
    assert plan["slice"] == (128 if c % 4 == 0 else 32)
    assert plan["blocks"] == tiles * -(-c // plan["slice"])
    assert plan["smem_bytes"] == kernel.smem_bytes() == 47184 <= fwd_kernel.SMEM_LIMIT
    assert plan["fits"] and plan["blocks_per_sm"] == 3
    assert plan["threads"] == 32 * kernel.TILE_H + 32 == 288
    if canvas == (704, 960):
        assert tiles == 885 and kernel.launch_plan(shapes, 256)["blocks"] == 1770


@pytest.mark.parametrize("tile_h,tile_w,depth", bench.BWD_SWEEP)
def test_sweep_variants_fit(tile_h, tile_w, depth, tmp_path, monkeypatch):
    """The benchmark's sweep builds fit a block; their sources differ from
    the current one only in the three constants."""
    assert kernel.smem_bytes(tile_h, tile_w, depth) <= fwd_kernel.SMEM_LIMIT
    assert 32 * tile_h + 32 <= 1024
    monkeypatch.setattr(bench.kbuild, "BUILD_DIR", tmp_path)
    src = bench.bwd_sweep_source(tile_h, tile_w, depth).read_text()
    assert f"constexpr int kTileH = {tile_h};" in src and f"kDepth = {depth};" in src
    cur = (build.CSRC_DIR / "roi_align_bwd.cu").read_text().splitlines()
    diff = [a for a, b in zip(src.splitlines(), cur) if a != b]
    assert len(src.splitlines()) == len(cur) and len(diff) <= 3


def test_old_interface_is_told_apart(tmp_path):
    """The atomics' C interface (a zeroed accumulator beside the output)
    goes through the benchmark's adapter; the current one does not."""
    old = tmp_path / "old.cu"
    old.write_text('extern "C" int sos_roi_align_bwd(int dtype, int num_levels, const int* hs,\n'
                   '    const int* ws, const float* scales, int c, const void* boxes,\n'
                   '    const void* level, const void* valid, int p, int ph, int pw,\n'
                   '    int sampling_ratio, int cap, int aligned, const void* grad, void* acc,\n'
                   '    void* out, void* stream) {')
    assert bench._old_bwd_interface(old)
    assert not bench._old_bwd_interface(build.CSRC_DIR / "roi_align_bwd.cu")


@pytest.mark.parametrize("canvas,dtype,ms", [((704, 960), torch.bfloat16, 0.0124),
                                             ((704, 960), torch.float32, 0.0248),
                                             ((1216, 1664), torch.bfloat16, 0.0295)])
def test_traffic_and_bound_at_the_training_shapes(canvas, dtype, ms):
    """g (512 x 49 x 256) read once and p2-p5 written once: 41.6 MB in bf16
    at 704 x 960, 0.0124 ms at 3.35 TB/s."""
    isz = torch.empty((), dtype=dtype).element_size()
    nbytes = kernel.traffic_bytes(TRAIN_SHAPES[canvas], 256, 512, isz)
    cells = sum(h * w for h, w in TRAIN_SHAPES[canvas])
    assert nbytes == 512 * 49 * 256 * isz + cells * 256 * isz + 512 * 21
    assert round(bound_ms(nbytes), 4) == ms


@pytest.mark.parametrize("canvas,image_hw,pairs,terms", [
    (bench.CANVAS, bench.IMAGE_HW, 47697, 378224),
    (bench.TOP_CANVAS, bench.TOP_IMAGE_HW, 48767, 384064)])
def test_tile_pairs_at_the_training_shapes(canvas, image_hw, pairs, terms):
    """The training inputs' bin-tile pairs (each reads a bin's g row once)
    and (bin, cell) terms, at 8 x 8 tiles: about 2 tiles and 8 terms a
    live bin."""
    _, shapes, boxes, valid, level, scales = bench.bwd_inputs("cpu", torch.bfloat16, 0, canvas,
                                                              image_hw)
    assert bench.tile_pairs(shapes, boxes, valid, level, scales) == (pairs, terms)


# --- the plain backward ------------------------------------------------------

def _case(canvas=(100, 132), p=30, c=5, seed=0, dtype=torch.float32, output_size=(7, 7)):
    """p2-p5 of a canvas whose maps have ragged 8 x 8 tiles, ROIs of every
    level (sides of 8 to 700 px, some outside the image, reversed and
    sub-cell ones), every seventh invalid, and a unit normal upstream
    gradient of ``output_size`` bins, all from numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in bench.STRIDES]
    side = np.array([8, 20, 60, 150, 300, 700])[np.arange(p) % 6, None] * \
        rng.uniform(0.8, 1.25, (p, 2))
    xy = rng.uniform(-20, canvas[1] - 10, (p, 2))
    b = np.concatenate([xy, xy + side], 1).astype(np.float32)
    b[0] = [0, 0, canvas[1], canvas[0]]
    b[1] = [30, 20, 22, 12]
    b[2] = [40, 40, 40.3, 40.2]
    boxes = torch.from_numpy(b)
    valid = torch.from_numpy(np.arange(p) % 7 != 3)
    level = assign_boxes_to_levels(boxes, 2, 5)
    grad = torch.from_numpy(rng.standard_normal((p, *output_size, c)).astype(np.float32)
                            ).to(dtype)
    return grad, shapes, boxes, valid, level, [1.0 / s for s in bench.STRIDES]


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("kw", [{}, {"sampling_ratio": 2}, {"aligned": False}])
def test_plain_backward_is_np_add_at_of_its_terms(kw):
    """The plain backward's sums are in (p, ph, pw) order: an f32
    ``np.add.at`` of the same terms (one per bin and cell, (gc * Y) * X),
    which adds in order, gives the same bits."""
    grad, shapes, boxes, valid, level, scales = _case(seed=1)
    at, rows, ysum, xsum, count = backward_terms(shapes, boxes, valid, level, scales, **kw)
    gc = grad.float().numpy() / count.numpy()[:, None, None, None]
    p, ph, pw = at[:, :3].numpy().T
    terms = gc[p, ph, pw] * ysum.numpy()[:, None] * xsum.numpy()[:, None]
    acc = np.zeros((sum(h * w for h, w in shapes), grad.shape[-1]), np.float32)
    np.add.at(acc, rows.numpy(), terms)
    got = roi_align_levels_backward_reference(grad.permute(0, 3, 1, 2), shapes, boxes, valid,
                                              level, scales, **kw)
    assert np.array_equal(torch.cat([g.reshape(-1, grad.shape[-1]) for g in got]).numpy()
                          .view(np.int32), acc.view(np.int32))
    assert not (at[:, 0:1] == torch.nonzero(~valid)[:, 0]).any()   # invalid ROIs add nothing


def test_plain_backward_terms_in_chunks(monkeypatch):
    """The terms go in chunks; any chunk size gives the same bits."""
    from sos_wsod_torch.ops import roi_align as ops

    grad, shapes, boxes, valid, level, scales = _case(seed=2)
    args = (grad.permute(0, 3, 1, 2), shapes, boxes, valid, level, scales)
    want = roi_align_levels_backward_reference(*args)
    monkeypatch.setattr(ops, "TERM_CHUNK", 7 * grad.shape[-1])
    for a, b in zip(roi_align_levels_backward_reference(*args), want):
        assert torch.equal(_bits(a), _bits(b))


# --- the tiled walk ----------------------------------------------------------

def _tables(first, bin_size, grid, n, bins, cap, t0, kt):
    """The kernel's axis_table for every ROI and bin at once: (P, bins, kt)
    sums of the factors of the cells t0 ... t0 + kt - 1, the samples in
    order and the lo factor first, and the (P, bins, kt) mask of cells the
    bin's samples touch."""
    v = fwd_kernel.sample_positions(first, bin_size, grid, bins, cap)
    lo, hi, low, high = fwd_kernel.axis_cells(v, n[:, None, None])
    ok = torch.arange(cap)[None, None, :] < grid[:, None, None]
    sums = torch.zeros((*v.shape[:2], kt))
    mask = torch.zeros((*v.shape[:2], kt), dtype=torch.bool)
    for i in range(cap):
        for cell, fac in ((lo[..., i], high[..., i]), (hi[..., i], low[..., i])):
            on = ok[..., i, None] & ((cell - t0)[..., None] == torch.arange(kt))
            sums = torch.where(on, sums + fac[..., None], sums)
            mask |= on
    return sums, mask


def _tiled_walk(grad, shapes, boxes, valid, level, scales, *, tile=(kernel.TILE_H, kernel.TILE_W),
                queue=kernel.QUEUE, tables=kernel.TABLES, output_size=(7, 7), sampling_ratio=0,
                aligned=True, sample_cap=8):
    """The kernel's walk: for each tile of each level the ROIs that meet it,
    in passes of 32 // (PH + PW) with rounds of at most ``queue`` bins and
    ``tables`` tables, the tables and bins a pass places, then the adds in
    queue order. Returns the levels' gradients in grad's dtype, the
    bin-tile pairs and the rounds."""
    ph_n, pw_n = output_size
    per = ph_n + pw_n
    group = 32 // per
    c = grad.shape[-1]
    g = fwd_kernel.roi_geometry(shapes, boxes, valid, level, scales, output_size=output_size,
                                sampling_ratio=sampling_ratio, aligned=aligned,
                                sample_cap=sample_cap)
    cap = g["cap"]
    count = torch.clamp(g["grid_h"] * g["grid_w"], min=1).float()
    lvl = level.long().clamp(0, len(shapes) - 1)
    outs, pairs, rounds = [], 0, 0
    for li, (h, w) in enumerate(shapes):
        out = torch.full((h, w, c), float("nan"))
        on_level = valid & (lvl == li)
        # the extreme samples of each ROI bound its cells
        ends = []
        for first, bin_size, grid, n, bins in ((g["y1"], g["bin_h"], g["grid_h"], h, ph_n),
                                                (g["x1"], g["bin_w"], g["grid_w"], w, pw_n)):
            v = fwd_kernel.sample_positions(first, bin_size, grid, bins, cap)
            idx = torch.arange(len(grid))
            a, b = v[:, 0, 0], v[idx, bins - 1, grid.long() - 1]
            lo = fwd_kernel.axis_cells(torch.minimum(a, b), torch.tensor(n))[0]
            hi = fwd_kernel.axis_cells(torch.maximum(a, b), torch.tensor(n))[1]
            ends.append((lo, hi))
        for ty0, tx0 in itertools.product(range(0, h, tile[0]), range(0, w, tile[1])):
            (ylo, yhi), (xlo, xhi) = ends
            hit = on_level & (ylo < ty0 + tile[0]) & (yhi >= ty0) & (xlo < tx0 + tile[1]) \
                & (xhi >= tx0)
            rois = torch.nonzero(hit)[:, 0]
            ysum, ymask = _tables(g["y1"][rois], g["bin_h"][rois], g["grid_h"][rois],
                                  torch.full((len(rois),), h, dtype=torch.int32), ph_n, cap, ty0,
                                  tile[0])
            xsum, xmask = _tables(g["x1"][rois], g["bin_w"][rois], g["grid_w"][rois],
                                  torch.full((len(rois),), w, dtype=torch.int32), pw_n, cap, tx0,
                                  tile[1])
            queued, nb, nt = [], 0, 0
            for k0 in range(0, len(rois), group):
                ks = range(k0, min(k0 + group, len(rois)))
                if nt + len(ks) * per > tables or nb + len(ks) * ph_n * pw_n > queue:
                    rounds, nb, nt = rounds + 1, 0, 0
                nt += sum(int(ymask[k].any(1).sum() + xmask[k].any(1).sum()) for k in ks)
                for k in ks:
                    for ph, pw in itertools.product(range(ph_n), range(pw_n)):
                        if ymask[k, ph].any() and xmask[k, pw].any():
                            queued.append((k, ph, pw))
                            nb += 1
                assert nb <= queue and nt <= tables
            rounds += 1
            pairs += len(queued)
            acc = torch.zeros((*tile, c))
            for k, ph, pw in queued:
                p = int(rois[k])
                gc = grad[p, ph, pw].float() / count[p]
                rows = torch.nonzero(ymask[k, ph])[:, 0]
                cols = torch.nonzero(xmask[k, pw])[:, 0]
                t = gc[None, :] * ysum[k, ph, rows][:, None]                     # (R, C)
                terms = t[:, None, :] * xsum[k, pw, cols][None, :, None]         # (R, Cc, C)
                acc[rows[:, None], cols[None, :]] = acc[rows[:, None], cols[None, :]] + terms
            y1, x1 = min(ty0 + tile[0], h), min(tx0 + tile[1], w)
            out[ty0:y1, tx0:x1] = acc[:y1 - ty0, :x1 - tx0]
        outs.append(out.to(grad.dtype))
    return outs, pairs, rounds


def _assert_walk_is_plain(args, **kw):
    grad, shapes, boxes, valid, level, scales = args
    got, pairs, rounds = _tiled_walk(*args, **kw)
    opts = {k: v for k, v in kw.items() if k not in ("tile", "queue", "tables")}
    want = roi_align_levels_backward_reference(grad.permute(0, 3, 1, 2), shapes, boxes, valid,
                                               level, scales, **opts)
    for a, b in zip(got, want):
        assert a.dtype == grad.dtype and torch.equal(_bits(a), _bits(b))
    return pairs, rounds


@pytest.mark.parametrize("tile,queue,tables", [
    ((kernel.TILE_H, kernel.TILE_W), kernel.QUEUE, kernel.TABLES),   # the build's
    ((4, 8), 98, 28),          # a round a pass: every pass hands over
    ((5, 3), 120, 40),         # ragged tiles everywhere
    ((16, 16), 200, 60)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiled_walk_is_the_plain_backward_bit_for_bit(tile, queue, tables, dtype):
    args = _case(dtype=dtype, seed=3)
    pairs, rounds = _assert_walk_is_plain(args, tile=tile, queue=queue, tables=tables)
    if tile == (kernel.TILE_H, kernel.TILE_W):
        assert pairs == bench.tile_pairs(*args[1:])[0]
    else:
        assert rounds > sum(-(-h // tile[0]) * -(-w // tile[1]) for h, w in args[1])


@pytest.mark.parametrize("kw", [{"aligned": False}, {"sample_cap": 16}, {"sampling_ratio": 20},
                                {"sampling_ratio": 3}, {"output_size": (14, 14)}])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiled_walk_options(kw, dtype):
    """V1, a cap of 16, fixed ratios (20: 40 table entries a bin along
    each axis in the plain version, at most a tile's side in the kernel's)
    and the mask head's 14 x 14 bins (196 a ROI: one ROI a pass, a pass's
    bins filling most of a queue)."""
    args = _case(dtype=dtype, seed=4, p=12 if kw.get("sampling_ratio") == 20 else 30,
                 output_size=kw.get("output_size", (7, 7)))
    _assert_walk_is_plain(args, tile=(8, 8), queue=kernel.QUEUE, tables=kernel.TABLES, **kw)


def test_tiled_walk_many_terms_a_cell():
    """A 24 x 32 map under 40 overlapping ROIs on one level, among them
    whole-map and outside ones: cells take tens of terms, whose f32 sum
    depends on their order; the walk keeps the plain version's."""
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 60, (40, 2))
    b = np.concatenate([xy, xy + rng.uniform(8, 80, (40, 2))], 1).astype(np.float32)
    b[0], b[1] = [0, 0, 128, 96], [-300, -300, -200, -250]
    boxes = torch.from_numpy(b)
    grad = torch.from_numpy(rng.standard_normal((40, 7, 7, 3)).astype(np.float32))
    args = (grad, [(24, 32)], boxes, torch.ones(40, dtype=torch.bool),
            torch.zeros(40, dtype=torch.int32), [0.25])
    at, rows, *_ = backward_terms(*args[1:])
    assert int(torch.bincount(rows).max()) >= 40
    _assert_walk_is_plain(args, tile=(8, 8), queue=kernel.QUEUE, tables=kernel.TABLES)
