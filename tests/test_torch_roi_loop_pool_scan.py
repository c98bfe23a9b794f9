"""Kernel E's walk (sos_wsod_torch/csrc/roi_loop_pool_fwd.cu), emulated in
numpy on the CPU and held to the plain ROILoopPool bit for bit.

The kernel cannot run here, so what it computes is kept checkable:

- the constants of ``kernels/roi_loop_pool.py`` equal the source's, and
  ``bench_roi_loop_pool.tile_grid`` sizes the staged grid as its launcher;
- ``fused_layout``, the wrapper's check of the layout the kernel reads (the
  frame rows' windows the box rows', the box rows' rectangles empty),
  accepts ``loop_windows`` and refuses other windows;
- ``tile_counts`` emulates how the staged branch's blocks find their work
  (a tile per block: the ROI rows whose window corners reach the tile, then
  a ballot of bin rows and one of bin columns), and every work item of the
  production, top training and adversarial inputs is answered by exactly
  one tile;
- ``walk`` emulates the scan of one work item: a (ROI, bin) pair of the box
  and frame rows (each window cell read and folded once: into the frame's
  maximum, or where it lies strictly inside the frame's rectangle into the
  inner cells', the row split at the rectangle by the kernel's formulas;
  the box's answer the first hit over the two), or a context bin; bf16 as
  32-bit words of two channels with the paired strict compare, bit selects
  and 16-bit offsets two to a word; f32 a channel at a time with int32
  positions. A window read from shared memory keeps its offsets from its
  first cell; one read from the map runs chunks of whole rows whose offsets
  stay below a span and resolves them into positions where a chunk raised
  the maximum. The tests shrink the span so that chunks end inside the
  production windows and across a plateau.

Tolerance: none. A max pool selects an input value and the scale multiply
is one rounding of an exact product, so the emulation and the plain version
agree bit for bit, and a '>=' compare (the last hit among ties) does not.
The card tests (tests/test_torch_roi_loop_pool_cuda.py, chip_smoke.py phase
4e) hold the kernel itself to the plain version.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from sos_wsod_torch.kernels import build
from sos_wsod_torch.kernels import roi_loop_pool as kernel
from sos_wsod_torch.ops.roi_loop_pool import loop_windows, roi_loop_pool_reference
from sos_wsod_torch.tools import bench_roi_loop_pool as bench
from sos_wsod_torch.tools.bench_roi_pool import production_pool_inputs

NONE = 0xFFFF
TRAIN_SHORT_SIDES = range(480, 1217, 32)   # voc07_oicr_plus.yaml INPUT.MIN_SIZE_TRAIN


def _split(y, w0, w1, ex):
    """The kernel's split(): [w0, xa) and [xb, w1) of row y lie outside the
    rectangle ex = (h1, h2, w1, w2), [xa, xb) strictly inside it."""
    cut = (y > ex[:, 0]) & (y < ex[:, 1])
    xa = np.where(cut, np.maximum(w0, np.minimum(w1, ex[:, 2] + 1)), w1)
    xb = np.where(cut, np.maximum(xa, np.minimum(w1, ex[:, 3])), w1)
    assert ((w0 <= xa) & (xa <= xb) & (xb <= w1)).all()   # the runs tile [w0, w1)
    return xa, xb


def _jobs(hs, ws, valid):
    """The kernel's work items of the valid ROIs as scans: (first row,
    second row or -1, fused, ph, pw). A fused item (the box and frame rows p
    and P + p over the box row's window) folds the cells strictly inside the
    frame's rectangle into its first side (the inner cells, merged with the
    second side into the box's answer) and the others into its second side
    (the frame); a context item folds its row's kept cells into its first
    side."""
    p, ph_n, pw_n = hs.shape[0] // 3, hs.shape[1], ws.shape[1]
    pp, ph, pw = np.meshgrid(np.arange(p), np.arange(ph_n), np.arange(pw_n), indexing="ij")
    live = valid[pp.ravel()]
    pp, ph, pw = pp.ravel()[live], ph.ravel()[live], pw.ravel()[live]
    n = len(pp)
    first = np.concatenate([pp, 2 * p + pp])
    second = np.concatenate([p + pp, -np.ones(n, int)])
    fused = np.arange(2 * n) < n
    return first, second, fused, np.concatenate([ph, ph]), np.concatenate([pw, pw])


class _Rows:
    """The running maxima and tracks of one side (first or second row) of
    every job: bf16 as uint32 words of two channels, f32 as uint32 bits."""

    def __init__(self, n, k, bf16, c_out):
        self.bf16 = bf16
        self.best = np.zeros((n, k), np.uint32)
        self.track = (np.full((n, k), 0xFFFFFFFF, np.uint32) if bf16
                      else np.full((n, k), -1, np.int64))
        self.arg = np.full((n, c_out), -1, np.int64)

    def fold(self, ix, v, mask, off, cell, strict):
        b = self.best[ix]
        if self.bf16:
            def halves(w):
                return ((w << 16).view(np.float32), (w & 0xFFFF0000).view(np.float32))
            (v_lo, v_hi), (b_lo, b_hi) = halves(v), halves(b)
            gt_lo = (v_lo > b_lo) if strict else (v_lo >= b_lo)
            gt_hi = (v_hi > b_hi) if strict else (v_hi >= b_hi)
            m = (np.where(gt_lo & mask[:, None], 0xFFFF, 0).astype(np.uint32)
                 | np.where(gt_hi & mask[:, None], 0xFFFF0000, 0).astype(np.uint32))
            self.best[ix] = (v & m) | (b & ~m)
            off2 = (off.astype(np.uint32) * np.uint32(0x10001))[:, None]
            self.track[ix] = (off2 & m) | (self.track[ix] & ~m)
        else:
            vf, bf = v.view(np.float32), b.view(np.float32)
            gt = ((vf > bf) if strict else (vf >= bf)) & mask[:, None]
            self.best[ix] = np.where(gt, v, b)
            self.track[ix] = np.where(gt, cell[:, None], self.track[ix])

    def resolve(self, ix, first):
        """Positions where the tracks hold one; the tracks start over."""
        t = self.track[ix]
        if self.bf16:
            o = np.stack([t & NONE, t >> 16], -1).reshape(len(ix), 2 * t.shape[1]).astype(np.int64)
            o = o[:, :self.arg.shape[1]]
            self.arg[ix] = np.where(o != NONE, first[ix, None] + o, self.arg[ix])
            self.track[ix] = 0xFFFFFFFF
        else:
            self.arg[ix] = np.where(t >= 0, t, self.arg[ix])
            self.track[ix] = -1

    def merge(self, ix, other, c):
        """Jobs ix: the first hit over this side's cells and other's: the
        larger value, of equal ones the smaller position (none, -1, last)."""
        va, vb = self.values(c)[ix], other.values(c)[ix]
        pa, pb = self.arg[ix], other.arg[ix]
        take = (vb > va) | ((vb == va) & (pb.astype(np.uint64) < pa.astype(np.uint64)))
        self.arg[ix] = np.where(take, pb, pa)
        merged = np.where(take, vb, va)
        if self.bf16:
            bits = (merged.view(np.uint32) >> 16).astype(np.uint32)
            if bits.shape[1] % 2:
                bits = np.concatenate([bits, np.zeros((len(ix), 1), np.uint32)], 1)
            self.best[ix] = bits[:, 0::2] | (bits[:, 1::2] << 16)
        else:
            self.best[ix] = merged.view(np.uint32)

    def values(self, c):
        if self.bf16:
            w = self.best
            v = np.stack([(w << 16).view(np.float32), (w & 0xFFFF0000).view(np.float32)], -1)
            return v.reshape(len(w), -1)[:, :c]
        return self.best.view(np.float32)


def walk(feat, hs, he, ws, we, ex, valid, row_scale=None, *, chunked: bool,
         span: int = kernel.SPAN, strict: bool = True):
    """The kernel's answer, emulated: (out (3P, PH, PW, C) feat.dtype, pos
    int32). ``chunked`` reads the windows as from the map (offsets from each
    chunk's first cell, chunks of whole rows below ``span``), else as from
    shared memory (offsets from the window's first cell); ``strict=False``
    compares with '>='."""
    h, w, c = feat.shape
    bf16 = feat.dtype == torch.bfloat16
    if bf16:
        bits = feat.contiguous().view(torch.int16).numpy().view(np.uint16)
        if c % 2:
            bits = np.concatenate([bits, np.zeros((h, w, 1), np.uint16)], 2)
        words = bits[..., 0::2].astype(np.uint32) | (bits[..., 1::2].astype(np.uint32) << 16)
    else:
        words = feat.contiguous().numpy().view(np.uint32)
    hs, he, ws, we, ex = (t.numpy().astype(np.int64) for t in (hs, he, ws, we, ex))
    a_row, b_row, fused, jph, jpw = _jobs(hs, ws, valid.numpy())
    n = len(a_row)
    h0, h1, w0, w1 = hs[a_row, jph], he[a_row, jph], ws[a_row, jpw], we[a_row, jpw]
    rect = ex[np.where(fused, b_row, a_row)]   # the frame's rectangle, or the context's
    nh, nw = np.maximum(h1 - h0, 0), np.maximum(w1 - w0, 0)
    if chunked:
        assert (nw <= span).all(), "a row wider than the span: the wrapper refuses such maps"
    acc_a, acc_b = (_Rows(n, words.shape[2], bf16, c) for _ in range(2))
    first = h0 * w + w0
    for dy in range(int(nh.max(initial=0))):
        iy = np.nonzero(nh > dy)[0]
        y = h0[iy] + dy
        row = y * w
        if chunked:
            new = (row + w1[iy] - 1 - first[iy]) >= span
            for acc in (acc_a, acc_b):
                acc.resolve(iy[new], first)
            first[iy[new]] = row[new] + w0[iy[new]]
        xa, xb = _split(y, w0[iy], w1[iy], rect[iy])
        for dx in range(int(nw[iy].max(initial=0))):
            sel = nw[iy] > dx
            ix = iy[sel]
            x = w0[ix] + dx
            cell = row[sel] + x
            v = words[y[sel], x]
            outside = (x < xa[sel]) | (x >= xb[sel])
            keep_a = np.where(fused[ix], ~outside, outside)
            keep_b = fused[ix] & outside
            off = cell - first[ix]
            assert (off < (span if chunked else kernel.SPAN)).all()
            acc_a.fold(ix, v, keep_a, off, cell, strict)
            acc_b.fold(ix, v, keep_b, off, cell, strict)
    every = np.arange(n)
    for acc in (acc_a, acc_b):
        acc.resolve(every, first)
    acc_a.merge(np.nonzero(fused)[0], acc_b, c)
    p3, ph_n, pw_n = hs.shape[0], hs.shape[1], ws.shape[1]
    out = torch.zeros((p3, ph_n, pw_n, c), dtype=feat.dtype)
    pos = torch.full((p3, ph_n, pw_n, c), -1, dtype=torch.int32)
    p = p3 // 3
    for acc, rows, take in ((acc_a, a_row, np.ones(n, bool)), (acc_b, b_row, fused)):
        vals = torch.from_numpy(acc.values(c)[take].copy())
        if row_scale is not None:
            scale = row_scale.to(feat.dtype).float()
            vals = vals * scale[torch.from_numpy(rows[take] % p)][:, None]
        r, i, j = (torch.from_numpy(t[take]) for t in (rows, jph, jpw))
        out[r, i, j] = vals.to(feat.dtype)
        pos[r, i, j] = torch.from_numpy(acc.arg[take].astype(np.int32))
    return out, pos


def reference(feat, hs, he, ws, we, ex, valid, row_scale=None, groups: int = 8):
    """``roi_loop_pool_reference`` over groups of ROIs of like window sizes
    (it walks the largest window of its rows, so one call over 4096 ROIs
    would walk the whole-image box's window for every bin)."""
    p = valid.shape[0]
    area = ((he - hs).clamp(min=0).amax(1) * (we - ws).clamp(min=0).amax(1)).view(3, p).amax(0)
    order = torch.argsort(area, stable=True)
    out = torch.empty((3 * p, hs.shape[1], ws.shape[1], feat.shape[2]), dtype=feat.dtype)
    pos = torch.empty(out.shape, dtype=torch.int32)
    for idx in torch.tensor_split(order, groups):
        rows = torch.cat([idx, p + idx, 2 * p + idx])
        o, q = roi_loop_pool_reference(feat, hs[rows], he[rows], ws[rows], we[rows], ex[rows],
                                       valid[idx], None if row_scale is None else row_scale[idx])
        out[rows], pos[rows] = o, q
    return out, pos


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _equal(got, want):
    return torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1], want[1])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: the plain version and the
    emulation run many small tensor ops, which slow down many times over
    when several test processes share the cores and each op spreads over
    all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _production(c, seed=0):
    """The production inputs (87 x 119 x 512, 4000 proposals in 4096
    slots), their first c channels."""
    feat32, boxes, valid, rs = production_pool_inputs("cpu", (87, 119, 512), seed)
    return (feat32[..., :c].contiguous(), loop_windows(boxes, valid, 87, 119, 7, 7, bench.SCALE),
            valid, rs)


@pytest.fixture(scope="module")
def production_bf16():
    """Every 4th slot of the production inputs (1024 of 4096 slots, 24 of
    them invalid) in bf16 at 2 channels, and the plain version's answer,
    shared by the walks."""
    feat32, win, valid, rs = _production(2)
    p = valid.shape[0]
    slots = torch.arange(0, p, 4)
    rows = torch.cat([slots, p + slots, 2 * p + slots])
    win = tuple(t[rows] for t in win)
    valid, rs = valid[slots], rs[slots]
    feat = feat32.to(torch.bfloat16)
    return feat, win, valid, rs, reference(feat, *win, valid, rs)


def test_constants_mirror_the_source():
    src = (build.CSRC_DIR / "roi_loop_pool_fwd.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert got["kRegion"] == kernel.REGION and got["kMaxWin"] == kernel.MAX_WIN
    assert "constexpr int kStride = kRegion - kMaxWin + 1;" in src
    assert got["kSpan"] == kernel.SPAN == 0xFFFF
    assert got["kMinBlocks"] == kernel.MIN_BLOCKS
    assert got["kCellVecs"] == bench.CELL_VECS
    # a staged window's offsets from its first cell stay below 0xffff
    assert (kernel.REGION - 1) * got["kTiledMaxW"] + kernel.REGION - 1 < kernel.SPAN
    # the region fits a block's shared memory on Hopper, beside the counter
    assert bench.tile_grid(87, 119, 512, torch.bfloat16)["smem_bytes"] + 4 <= 227 * 1024
    assert "kRegion * kRegion * kCellVecs * 16" in src


def test_staged_grid():
    """The production map is 11 x 15 tiles of 8 x 8 cells, two channel
    groups in bf16, each tile's work split over two blocks (660 blocks),
    four groups in f32 (660 blocks); the top training map is not split; 136
    bf16 channels fill one group."""
    bf, f32 = torch.bfloat16, torch.float32
    grid = bench.tile_grid(87, 119, 512, bf)
    assert (grid["tiles_y"], grid["tiles_x"], grid["groups"], grid["split"]) == (11, 15, 2, 2)
    assert grid["blocks"] == 660 and bench.tile_grid(87, 119, 512, f32)["blocks"] == 660
    assert bench.tile_grid(152, 204, 512, bf)["split"] == 1
    assert bench.tile_grid(87, 119, 136, bf)["groups"] == 1
    # each of the 2 blocks of a tile stages its region clipped to the map: the
    # regions' rows add up to 9 x 20 + 15 + 7, their columns to 13 x 20 + 15 + 7
    assert grid["staged_bytes"] == 202 * 282 * 512 * 2 * 2


def _shift_frame_rows(win, p):
    hs, he, ws, we, ex = (t.clone() for t in win)
    hs[p:p + 20] = (hs[p:p + 20] - 1).clamp(min=0)
    return hs, he, ws, we, ex


def _box_rectangles(win, p):
    hs, he, ws, we, ex = (t.clone() for t in win)
    ex[:10] = ex[p:p + 10]
    return hs, he, ws, we, ex


@pytest.mark.parametrize("change,fits", [(None, True), (_shift_frame_rows, False),
                                         (_box_rectangles, False)])
def test_fused_layout(change, fits):
    """The wrapper's check: loop_windows' windows have the layout the
    kernel reads; frame windows shifted from the box rows', or box rows with
    a rectangle of their own, do not, and the kernel's walk (which reads the
    box rows' windows and the frame rows' rectangles only) would not answer
    them as the plain version does, so the wrapper raises for them."""
    feat32, boxes, valid, rs = bench.adversarial_inputs("cpu", 4, seed=4)
    win = loop_windows(boxes, valid, 24, 40, 7, 7, bench.SCALE)
    if change is not None:
        win = change(win, valid.shape[0])
    assert bool(kernel.fused_layout(*win)) is fits
    want = roi_loop_pool_reference(feat32, *win, valid, rs)
    assert _equal(walk(feat32, *win, valid, rs, chunked=False), want) is fits


def tile_counts(hs, he, ws, we, valid, h, w):
    """How many tiles answer each work item (2, P, PH, PW) [box-and-frame;
    context], as the staged branch finds them. A tile takes the valid ROIs'
    rows whose window corners (clamped into the map) reach its cells, then
    the bins whose row corner and column corner both lie there: the tiles'
    cells partition the map, so the only tile that can take a bin is the one
    holding its corner, and it takes it where the ROI row's corners reach
    that tile. Tile t blanks bins skew, skew + tiles, ... of an invalid ROI
    p, skew = (t - p PH PW) mod tiles."""
    s = kernel.STRIDE
    p, ph, pw = valid.shape[0], hs.shape[1], ws.shape[1]
    wr = torch.cat([torch.arange(p), 2 * p + torch.arange(p)])
    live = valid.repeat(2)
    own_h, own_w = hs[wr].long().clamp(max=h - 1), ws[wr].long().clamp(max=w - 1)
    ya, yb = own_h.amin(1, keepdim=True), own_h.amax(1, keepdim=True)
    xa, xb = own_w.amin(1, keepdim=True), own_w.amax(1, keepdim=True)
    y0, x0 = own_h // s * s, own_w // s * s   # the corner's tile, by row and by column
    reach_h = (yb >= y0) & (ya < y0 + s)
    reach_w = (xb >= x0) & (xa < x0 + s)
    count = (live[:, None, None] & reach_h[:, :, None] & reach_w[:, None, :]).int()
    tiles = -(-h // s) * -(-w // s)
    dead = torch.nonzero(~valid)[:, 0]
    bins = torch.arange(ph * pw)
    skew = (torch.arange(tiles)[:, None] - dead[None, :] * ph * pw) % tiles   # (tiles, dead)
    mine = (bins >= skew[..., None]) & ((bins - skew[..., None]) % tiles == 0)
    blanks = mine.sum(0).view(-1, ph, pw).int()
    count[dead] += blanks
    count[p + dead] += blanks
    return count.view(2, p, ph, pw)


@pytest.mark.parametrize("hw", [(87, 119), (152, 204)])
def test_tiles_answer_each_item_once(hw):
    """Every box-and-frame and context item of the main path's inputs, valid
    or not, is found by exactly one tile; and most window cells of the
    production inputs are read from shared memory."""
    _, boxes, valid, _ = production_pool_inputs("cpu", (*hw, 512))
    hs, he, ws, we, ex = loop_windows(boxes, valid, *hw, 7, 7, bench.SCALE)
    assert (tile_counts(hs, he, ws, we, valid, *hw) == 1).all()
    reads = bench.staged_reads(hs, he, ws, we, ex, valid, *hw)
    assert reads["shared"] + reads["map"] == bench.scan_cells(hs, he, ws, we, ex, valid)["fused"]
    if hw == (87, 119):
        assert reads["shared"] > 0.97 * (reads["shared"] + reads["map"])


def test_tiles_answer_each_adversarial_item_once():
    _, boxes, valid, _ = bench.adversarial_inputs("cpu", 4, seed=1)
    hs, he, ws, we, _ = loop_windows(boxes, valid, 24, 40, 7, 7, bench.SCALE)
    assert (tile_counts(hs, he, ws, we, valid, 24, 40) == 1).all()


def test_cells_scanned_at_the_production_shape():
    """The window cells of the production inputs: the first design read the
    box, frame and context cells (10.10 M a channel), the fused scan reads
    the box windows once for both rows (7.81 M)."""
    _, (hs, he, ws, we, ex), valid, _ = _production(1)
    cells = bench.scan_cells(hs, he, ws, we, ex, valid)
    assert cells == {"box": 3_031_795, "frame": 2_291_536, "context": 4_777_867,
                     "first_design": 10_101_198, "fused": 7_809_662}


@pytest.mark.parametrize("chunked,span", [(False, kernel.SPAN), (True, 200)])
def test_walk_equals_plain_version_on_production_windows(production_bf16, chunked, span):
    """The windows and rectangles of a quarter of the production inputs
    (1024 slots on 87 x 119, two bf16 channels: one word of the paired
    compare), with scale: the staged walk, and the direct walk with chunks
    of one or two rows (span 200 on a 119-wide map). f32 takes the other
    inputs below."""
    feat, win, valid, rs, want = production_bf16
    assert _equal(walk(feat, *win, valid, rs, chunked=chunked, span=span), want)


@pytest.mark.parametrize("c", [136, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_walk_equals_plain_version_on_adversarial_inputs(c, dtype):
    """bench.adversarial_inputs: zero and negative blocks, whole-image, edge,
    sub-cell, empty and invalid boxes; both walks, with and without scale."""
    feat32, boxes, valid, rs = bench.adversarial_inputs("cpu", c, seed=1)
    win = loop_windows(boxes, valid, 24, 40, 7, 7, bench.SCALE)
    feat = feat32.to(dtype)
    for scale in (rs, None):
        want = roi_loop_pool_reference(feat, *win, valid, scale)
        for chunked in (False, True):
            assert _equal(walk(feat, *win, valid, scale, chunked=chunked, span=40), want)


@pytest.fixture(scope="module")
def constant_case():
    """Adversarial windows on a constant map of 1.5, and each bin's first
    kept cell, found by listing the kept cells of its window in scan order."""
    _, boxes, valid, rs = bench.adversarial_inputs("cpu", 4, seed=2)
    win = loop_windows(boxes, valid, 24, 40, 7, 7, bench.SCALE)
    hs, he, ws, we, ex = (t.tolist() for t in win)
    rows = len(hs)
    first = torch.full((rows, 7, 7), -1, dtype=torch.int32)
    for r in range(rows):
        if not valid[r % (rows // 3)]:
            continue
        for i in range(7):
            for j in range(7):
                kept = [y * 40 + x for y in range(hs[r][i], he[r][i])
                        for x in range(ws[r][j], we[r][j])
                        if not (ex[r][0] < y < ex[r][1] and ex[r][2] < x < ex[r][3])]
                if kept:
                    first[r, i, j] = kept[0]
    return torch.full((24, 40, 4), 1.5), win, valid, rs, first


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_constant_map_answers_the_first_kept_cell(constant_case, dtype):
    """On a constant positive map every bin's answer is its first kept cell;
    a '>=' compare answers the last and fails."""
    feat32, win, valid, rs, first = constant_case
    feat = feat32.to(dtype)
    want = roi_loop_pool_reference(feat, *win, valid, rs)
    assert torch.equal(want[1], first[..., None].expand_as(want[1]))
    for chunked in (False, True):
        assert _equal(walk(feat, *win, valid, rs, chunked=chunked, span=40), want)
        assert not _equal(walk(feat, *win, valid, rs, chunked=chunked, span=40, strict=False),
                          want)


def test_plateau_across_chunks():
    """A plateau of equal maxima over rows 6-15 of a 24 x 40 map: with a
    span of 40 every row is a chunk of its own, so ties meet across chunk
    ends; the strict compare keeps the first hit there, '>=' does not."""
    rng = np.random.RandomState(5)
    feat32, boxes, valid, rs = bench.adversarial_inputs("cpu", 8, seed=3)
    base = torch.from_numpy(rng.uniform(0.1, 1.0, (24, 40, 8)).astype(np.float32))
    base[6:16, 4:36] = 2.0
    boxes[:16] = torch.tensor([[24.0, 40.0, 300.0, 150.0]]) + torch.from_numpy(
        rng.uniform(-16, 16, (16, 4)).astype(np.float32))
    win = loop_windows(boxes, valid, 24, 40, 7, 7, bench.SCALE)
    for dtype in (torch.bfloat16, torch.float32):
        feat = base.to(dtype)
        want = roi_loop_pool_reference(feat, *win, valid, rs)
        got = walk(feat, *win, valid, rs, chunked=True, span=40)
        assert _equal(got, want)
        assert not _equal(walk(feat, *win, valid, rs, chunked=True, span=40, strict=False), want)
        assert _equal(walk(feat, *win, valid, rs, chunked=False), want)
