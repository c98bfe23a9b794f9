"""The ROIPool backward kernel's launch plan and tiled walk, on the CPU.

``sos_wsod_torch/csrc/roi_pool_bwd.cu`` cannot run here, so what it computes
is kept checkable in two ways:

- the launch plan (``kernels/roi_pool_bwd.py:launch_plan``): tile, channel
  slice, threads, shared memory and grid, from constants that must equal the
  source's. Shared memory stays within Hopper's 227 KB a block and does not
  depend on the map or the number of ROIs;
- an emulation of the kernel's walk in plain PyTorch (``_tiled_walk``): for
  every tile, the queue of bins whose windows meet it, filled from
  ``bin_windows`` as the kernel's threads fill it (a few ROIs a round, a
  bounded queue that resumes at the first bin that did not fit), then each
  lane taking its channel's entries whose pos falls in the tile, in queue
  order, in f32 with one rounding for each product and each add. Small ROI rounds and
  queues force the resume paths. The emulation must equal the plain version
  (``roi_pool_backward_reference``) and an f32 ``np.add.at`` bit for bit,
  and the Pallas VJP (interpret mode) after the cast to bf16, exactly.

The emulation cannot see the .cu drift from it: the card tests
(``tests/test_torch_roi_pool_cuda.py``) hold the kernel bit-identical to the
plain version run on the CPU, and to itself across launches.
"""
from __future__ import annotations

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.ops.pallas.roi_pool_fused import roi_pool_fused
from sos_wsod_torch.kernels import build
from sos_wsod_torch.kernels import roi_pool_bwd as kernel
from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool_backward_reference, roi_pool_reference
from sos_wsod_torch.tools import bench_roi_pool as bench


# --- the launch plan -------------------------------------------------------

def test_constants_mirror_the_source():
    src = (build.CSRC_DIR / "roi_pool_bwd.cu").read_text()
    want = {"kTileH": kernel.TILE_H, "kTileW": kernel.TILE_W, "kWarps": kernel.WARPS,
            "kAdds": kernel.ADDS, "kQueue": kernel.QUEUE, "kRois": kernel.ROIS}
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: got[k] for k in want} == want
    code = re.sub(r"//.*", "", src)
    assert "atomic" not in code                        # no atomics, global or shared
    assert "H * W" not in code and "kSlice = kWarps * 32" in code


@pytest.mark.parametrize("c", [1, 3, 200, 512])
def test_launch_plan_up_to_the_largest_map(c):
    """Every map up to 152 x 256 (the largest VOC training map's plain5):
    the same shared memory, within the 232,448 bytes a block may use; one
    block for each tile and channel slice, a warp for each 32 channels."""
    th, tw, sl = kernel.TILE_H, kernel.TILE_W, kernel.SLICE
    smem = set()
    for h, w in itertools.product([1, 7, 8, 9, 15, 16, 17, 87, 152], [1, 16, 33, 119, 204, 256]):
        plan = kernel.launch_plan(h, w, c)
        smem.add(plan["smem_bytes"])
        assert plan["blocks"] == -(-h // th) * -(-w // tw) * -(-c // sl)
        assert plan["tile"] == (th, tw) and plan["slice"] == sl == plan["threads"] - 32
    assert smem == {kernel.smem_bytes()} and kernel.smem_bytes() <= kernel.SMEM_LIMIT
    # the f32 tile x slice, two queues of bins and scales, the ROI list
    assert kernel.smem_bytes() == 4 * (th * tw * sl + 4 * kernel.QUEUE + 4 + 32 * kernel.ROIS)
    assert kernel.launch_plan(87, 119, 512)["blocks"] == 660   # 165 tiles x 4 slices


@pytest.mark.parametrize("tile_h,tile_w,warps", bench.SWEEP)
def test_sweep_variants_fit(tile_h, tile_w, warps, tmp_path, monkeypatch):
    """The benchmark's sweep builds fit a block; their sources differ from
    the current one only in the three constants."""
    assert kernel.smem_bytes(tile_h, tile_w, warps) <= kernel.SMEM_LIMIT and warps * 32 < 1024
    monkeypatch.setattr(bench.kbuild, "BUILD_DIR", tmp_path)
    src = bench.sweep_source(tile_h, tile_w, warps).read_text()
    assert f"constexpr int kTileH = {tile_h};" in src and f"kWarps = {warps};" in src
    cur = (build.CSRC_DIR / "roi_pool_bwd.cu").read_text().splitlines()
    diff = [a for a, b in zip(src.splitlines(), cur) if a != b]
    assert len(src.splitlines()) == len(cur) and len(diff) <= 3


def test_old_interface_is_told_apart(tmp_path):
    old = tmp_path / "old.cu"
    old.write_text('extern "C" int sos_roi_pool_bwd(int dtype, const void* g, const void* pos,\n'
                   '    const void* rs, int P, int PH, int PW, int C, void* acc, void* stream) {')
    assert bench._old_interface(old)
    assert not bench._old_interface(build.CSRC_DIR / "roi_pool_bwd.cu")


def test_traffic_and_bound_at_the_production_shape():
    """g (bf16) and pos read once, scales, windows and valid read once, the
    f32 map written once: 0.1905 ms at 87x119x512, 0.2031 at 152x204x512."""
    nbytes = bench.bwd_traffic_bytes(87, 119, 512, 4096, 7, 7, 2)
    assert nbytes == 4096 * 49 * 512 * 6 + 4 * 4096 + 4096 * 112 + 4096 + 87 * 119 * 512 * 4
    assert bench.bound_ms(nbytes) == pytest.approx(0.19052, abs=1e-5)
    assert bench.bound_ms(bench.bwd_traffic_bytes(152, 204, 512, 4096, 7, 7, 2)) \
        == pytest.approx(0.20315, abs=1e-5)


@pytest.mark.parametrize("hwc,tile,pairs", [
    ((87, 119, 512), (16, 16), 277066), ((152, 204, 512), (16, 16), 341185),
    ((87, 119, 512), (8, 8), 363309), ((152, 204, 512), (8, 8), 527106)])
def test_tile_pairs_at_the_production_shape(hwc, tile, pairs):
    """The bin-tile pairs of the main path's inputs (196,000 live bins): at
    16 x 16 tiles 1.41 and 1.74 tiles a live bin, at 8 x 8 1.85 and 2.69."""
    _, boxes, valid, _ = bench.production_pool_inputs("cpu", hwc)
    win = bin_windows(boxes, valid, hwc[0], hwc[1], 7, 7, 0.125)
    assert kernel.tile_incidences(*win, valid, tile) == pairs


# --- the tiled walk --------------------------------------------------------

def _span(s, e, lo, hi):
    """The kernel's span(): the run of non-empty windows meeting [lo, hi)."""
    hits = [i for i in range(len(s)) if e[i] > s[i] and e[i] > lo and s[i] < hi]
    return (hits[0], hits[-1] - hits[0] + 1) if hits else (0, 0)


def _queues(win, valid, tile, threads, capacity, rois=kernel.ROIS):
    """The kernel's queue rounds for one tile: lists of (bin, window rows,
    ROI), in the order the kernel's threads write them; a round of the fill
    tests ``threads`` x ``rois`` ROIs, each thread ``rois`` in a row."""
    hs, he, ws, we = (t.tolist() for t in win)
    (ty0, ty1), (tx0, tx1) = tile
    p_n, ph_n, pw_n = len(hs), len(hs[0]), len(ws[0])
    p0 = k0 = 0
    while True:
        queue = []
        while len(queue) < capacity and p0 < p_n:
            rects = []
            for t in range(threads * rois):
                p = p0 + t
                a = nh = b = nw = 0
                if p < p_n and valid[p] and hs[p][0] < ty1 and he[p][-1] > ty0 \
                        and ws[p][0] < tx1 and we[p][-1] > tx0:
                    a, nh = _span(hs[p], he[p], ty0, ty1)
                    b, nw = _span(ws[p], we[p], tx0, tx1)
                skip = k0 if t == 0 else 0
                rects.append((p, a, b, nw, nh * nw - skip, skip))
            offs = np.concatenate([[0], np.cumsum([r[4] for r in rects])])
            total, room, base = int(offs[-1]), capacity - len(queue), len(queue)
            for (p, a, b, nw, n, skip), off in zip(rects, offs[:-1]):
                for j in range(n):
                    if off + j >= room:
                        break
                    k = j + skip
                    ph, pw = a + k // nw, b + k % nw
                    assert len(queue) == base + off + j
                    queue.append(((p * ph_n + ph) * pw_n + pw, (hs[p][ph], he[p][ph]), p))
            if total <= room:
                p0, k0 = p0 + threads * rois, 0
            else:
                (p0, k0), = [(p, skip + room - off) for (p, _, _, _, n, skip), off
                             in zip(rects, offs[:-1]) if n > 0 and off <= room < off + n]
        yield queue
        if p0 >= p_n:
            break


def _tiled_walk(g, pos, rs, win, valid, h, w, tile_hw=(8, 8), slice_=128, threads=32,
                capacity=512, adds=8):
    """The kernel's walk: per tile and channel slice an f32 tile; each lane
    takes its channel's entries ``adds`` bins at a time in queue order,
    keeps those whose pos falls in the tile and adds them in that order.
    Returns the (h, w, C) map and the number of queued bins (the bin-tile
    pairs)."""
    p_n, ph_n, pw_n, c = g.shape
    gf = g.float().reshape(p_n * ph_n * pw_n, c)
    pos2 = pos.reshape(p_n * ph_n * pw_n, c).long()
    out = torch.full((h, w, c), float("nan"))
    pairs = 0
    for ty0, tx0 in itertools.product(range(0, h, tile_hw[0]), range(0, w, tile_hw[1])):
        tile = ((ty0, min(ty0 + tile_hw[0], h)), (tx0, min(tx0 + tile_hw[1], w)))
        rounds = list(_queues(win, valid, tile, threads, capacity))
        pairs += sum(map(len, rounds))
        for c0 in range(0, c, slice_):
            ch = torch.arange(c0, min(c0 + slice_, c))
            acc = torch.zeros((tile_hw[0] * tile_hw[1], len(ch)))
            for queue in rounds:
                for i0 in range(0, len(queue), adds):
                    for bin_, _, p in queue[i0:i0 + adds]:
                        q = pos2[bin_, ch]
                        y, x = q // w, q % w
                        v = gf[bin_, ch]
                        if rs is not None:
                            v = v * rs[p]                    # f32, one rounding
                        m = (q >= 0) & (y >= ty0) & (y < tile[0][1]) & (x >= tx0) & \
                            (x < tile[1][1])
                        cell = (y[m] - ty0) * tile_hw[1] + x[m] - tx0
                        acc[cell, m.nonzero()[:, 0]] += v[m]   # one cell a channel
            (y0, y1), (x0, x1) = tile
            out[y0:y1, x0:x1, ch] = acc.reshape(*tile_hw, -1)[:y1 - y0, :x1 - x0]
    return out, pairs


def _case(h, w, c, p, seed, dtype=torch.float32):
    """Features with a tie plateau; boxes of every size, some past the map's
    edge (clipped, empty bins) and the whole map; invalid slots; scales; and
    a cotangent, all made with numpy from a seed. Returns the backward's
    inputs (pos from the plain forward), then the features and boxes."""
    rng = np.random.RandomState(seed)
    feat = rng.randn(h, w, c).astype(np.float32)
    feat[2:6, 3:9] = 0.75                                  # ties: first hit
    img_h, img_w = 8 * h, 8 * w
    x1, y1 = rng.uniform(-30, img_w, p), rng.uniform(-30, img_h, p)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, img_w, p), y1 + rng.uniform(0, img_h, p)], 1)
    boxes[:4] = [[0, 0, img_w, img_h], [4, 4, 5, 5], [img_w + 8, 8, img_w + 60, 40],
                 [16, 16, 72, 64]]                         # whole, sub-cell, outside, plateau
    valid = torch.from_numpy(rng.rand(p) > 0.2)
    valid[:4] = True
    rs = torch.from_numpy(rng.uniform(1, 2, p).astype(np.float32))
    g = torch.from_numpy(rng.randn(p, 7, 7, c).astype(np.float32)).to(dtype)
    win = bin_windows(torch.from_numpy(boxes.astype(np.float32)), valid, h, w, 7, 7, 0.125)
    _, pos = roi_pool_reference(torch.from_numpy(feat).to(dtype), *win, valid)
    return g, pos, rs.to(dtype).float(), win, valid, feat, boxes.astype(np.float32)


def _np_add_at(g, pos, rs, h, w):
    """f32 oracle: np.add.at of the f32 products, in (bin, channel) order."""
    c = g.shape[-1]
    v = g.float().numpy().reshape(-1, c)
    if rs is not None:
        v = v * np.repeat(rs.numpy(), 49)[:, None]
    q = pos.numpy().reshape(-1, c)
    acc = np.zeros((h * w, c), np.float32)
    m = q >= 0
    np.add.at(acc, (q[m], np.nonzero(m)[1]), v[m])
    return acc.reshape(h, w, c)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("tile_hw,slice_,threads,capacity", [
    ((kernel.TILE_H, kernel.TILE_W), kernel.SLICE, 32, kernel.QUEUE),   # the build's
    ((4, 8), 2, 2, 16),              # ragged tiles and slices, queues that fill
    ((8, 4), 3, 1, 5),               # a queue shorter than a ROI's bins
    ((5, 7), 4, 8, 1),               # one bin a round
])
@pytest.mark.parametrize("hwc", [(13, 21, 3), (20, 33, 5)])
def test_tiled_walk_is_the_plain_version_bit_for_bit(tile_hw, slice_, threads, capacity, hwc):
    h, w, c = hwc
    g, pos, rs, win, valid, *_ = _case(h, w, c, 24, seed=h + w)
    assert (pos < 0).any() and (pos >= 0).any()
    live = (win[1] > win[0])[:, :, None] & (win[3] > win[2])[:, None, :] & valid[:, None, None]
    assert not bool(live.all())                             # empty and invalid bins
    for scale in (rs, None):
        got, pairs = _tiled_walk(g, pos, scale, win, valid, h, w, tile_hw, slice_, threads,
                                 capacity)
        want = roi_pool_backward_reference(g, pos, scale, h, w)
        assert torch.equal(_bits(got), _bits(want))
        assert np.array_equal(got.numpy().view(np.int32),
                              _np_add_at(g, pos, scale, h, w).view(np.int32))
        assert pairs == kernel.tile_incidences(*win, valid, tile_hw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiled_walk_on_many_terms_a_cell(dtype):
    """A 6x9 map under 40 ROIs: cells take up to 73 terms, whose f32
    sum depends on their order; the walk keeps the plain version's."""
    h, w, c = 6, 9, 4
    g, pos, rs, win, valid, *_ = _case(h, w, c, 40, seed=5, dtype=dtype)
    got, _ = _tiled_walk(g, pos, rs, win, valid, h, w, (4, 4), 2, 16, 32)
    want = roi_pool_backward_reference(g, pos, rs, h, w)
    counts = roi_pool_backward_reference(torch.ones_like(g), pos, None, h, w)
    assert int(counts.max()) == 73
    assert torch.equal(_bits(got), _bits(want))


def test_plain_version_is_np_add_at_at_production_scale():
    """The order the kernel keeps is the CPU index_add_'s: at 87x119x16 with
    the main path's 4096 slots, index_add_ equals an f32 np.add.at."""
    _, boxes, valid, rs = bench.production_pool_inputs("cpu", (87, 119, 16))
    feat = torch.from_numpy(np.random.RandomState(2).randn(87, 119, 16).astype(np.float32))
    win = bin_windows(boxes, valid, 87, 119, 7, 7, 0.125)
    _, pos = roi_pool_reference(feat, *win, valid)
    g = torch.from_numpy(np.random.RandomState(3).randn(4096, 7, 7, 16).astype(np.float32))
    got = roi_pool_backward_reference(g, pos, rs, 87, 119)
    assert np.array_equal(got.numpy().view(np.int32),
                          _np_add_at(g, pos, rs, 87, 119).view(np.int32))


@pytest.mark.parametrize("tile_hw,slice_,capacity", [((8, 8), 128, 512), ((4, 8), 16, 24)])
def test_tiled_walk_is_the_pallas_vjp_interpret(tile_hw, slice_, capacity):
    """bf16 features, cotangent and scale: the walk's f32 map cast to bf16
    equals the VJP of roi_pool_fused (interpret mode) exactly: both add the
    same f32 products in bin order and cast once."""
    h, w, c, p = 24, 40, 64, 12
    g, pos, rs, win, valid, feat, boxes = _case(h, w, c, p, seed=9, dtype=torch.bfloat16)

    def loss(f):
        out = roi_pool_fused(f, jnp.asarray(boxes), jnp.asarray(valid.numpy()),
                             jnp.asarray(rs.numpy()), 0.125, (7, 7), True)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(g.float().numpy()))

    want = np.asarray(jax.grad(loss)(jnp.asarray(feat, jnp.bfloat16)), np.float32)
    got, _ = _tiled_walk(g, pos, rs, win, valid, h, w, tile_hw, slice_, 32, capacity)
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(), want)

