"""The host side of the ROIPool forward's measurement and design, on the CPU.

- ``sos_wsod_torch/tools/bench_roi_pool.py``: the production inputs that
  chip_smoke.py and the card tests share, the bytes behind the bound, the
  window cells the kernel reads from L2, and the bit-identity check that
  chip_smoke.py runs on the wrapper and the tool on every build it times;
- ``kernels/build.py``: a library's name follows its source, so a baseline
  source never reuses another's build;
- the kernel's window walk (``csrc/roi_pool_fwd.cu``): each lane walks its
  window as one flat h-major index, in chunks whose flat positions lie
  within kSpan - 1 of the chunk's first cell (its bf16 positions are 16-bit
  offsets from there); it loads ``kUnroll`` cells before it compares them
  (past the chunk's end it re-reads a cell and does not compare), and
  compares in scan order. The emulation below repeats that index arithmetic
  in Python and must give the plain version's out and pos, and the Pallas
  kernel's (run in interpret mode) that the CUDA kernel replaces. The
  emulation cannot see the .cu itself drift from it: the card tests
  (``tests/test_torch_roi_pool_cuda.py``) hold the kernel to the plain
  version, windows past one chunk included.
"""
from __future__ import annotations

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sos_wsod_tpu.ops.pallas.roi_pool_fused import _roi_pool_fused_fwd_impl
from sos_wsod_torch.kernels import build
from sos_wsod_torch.ops.roi_pool import bin_windows, roi_pool_reference
from sos_wsod_torch.tools import bench_roi_pool as bench
from sos_wsod_torch.tools.measure import bound_ms


def test_production_inputs():
    """4096 slots, 4000 live, the special boxes first, a tie plateau; the
    same from the same seed."""
    feat, boxes, valid, rs = bench.production_pool_inputs("cpu", (87, 119, 512))
    assert feat.shape == (87, 119, 512) and feat.dtype == torch.float32
    assert boxes.shape == (4096, 4) and int(valid.sum()) == 4000 and not valid[4000:].any()
    np.testing.assert_array_equal(boxes[:3].numpy(), [[0, 0, 917, 688], [5, 5, 6, 6],
                                                      [913, 684, 917, 688]])
    assert bool((feat[10:30, 20:50] == 1.5).all())
    assert float(rs.min()) >= 1 and float(rs.max()) <= 2
    again = bench.production_pool_inputs("cpu", (87, 119, 512))
    assert all(torch.equal(a, b) for a, b in zip(again, (feat, boxes, valid, rs)))


def test_traffic_and_bound_at_the_production_shape():
    """The map, windows, valid and scales read once; out and pos written
    once: 627.6 MB with pos (0.187 ms at 3.35 TB/s), 216.6 MB without."""
    with_pos = bench.fwd_traffic_bytes(87, 119, 512, 4096, 7, 7, 2, True)
    without = bench.fwd_traffic_bytes(87, 119, 512, 4096, 7, 7, 2, False)
    feat = 87 * 119 * 512 * 2
    out = 4096 * 49 * 512 * 2
    small = 4 * 4096 * 7 * 4 + 4096 + 4 * 4096
    assert with_pos == feat + small + 3 * out
    assert without == feat + small + out
    assert bound_ms(with_pos) == pytest.approx(0.18736, abs=1e-5)
    assert bound_ms(without) == pytest.approx(0.06466, abs=1e-5)
    assert bound_ms(bench.fwd_traffic_bytes(152, 204, 512, 4096, 7, 7, 2, True)) \
        == pytest.approx(0.1936, abs=1e-4)


def test_window_cells_count_every_live_bin():
    rng = np.random.RandomState(1)
    h, w, p = 13, 17, 30
    boxes = torch.from_numpy(rng.uniform(-10, 150, (p, 4)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(p) > 0.3)
    hs, he, ws, we = bin_windows(boxes, valid, h, w, 7, 7, 0.125)
    want = sum(max(int(he[i, a] - hs[i, a]), 0) * max(int(we[i, b] - ws[i, b]), 0)
               for i in range(p) if valid[i] for a in range(7) for b in range(7))
    assert bench.window_cells(hs, he, ws, we, valid) == want


def test_library_name_follows_source(tmp_path):
    copy = tmp_path / "roi_pool_fwd.cu"
    shutil.copy(build.CSRC_DIR / "roi_pool_fwd.cu", copy)
    assert build.library_path("roi_pool_fwd", copy) == build.library_path("roi_pool_fwd")
    copy.write_text(copy.read_text() + "\n// edited\n")
    assert build.library_path("roi_pool_fwd", copy) != build.library_path("roi_pool_fwd")


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main([])


def _plain_pool(feat, win, valid, rs, with_pos):
    out, pos = roi_pool_reference(feat, *win, valid, rs)
    return out, (pos if with_pos else None)


def _check_inputs():
    feat, boxes, valid, rs = bench.production_pool_inputs("cpu", (12, 17, 8))
    keep = torch.arange(4096) < 40          # a few slots, the special boxes among them
    boxes, valid, rs = boxes[keep], valid[keep], rs[keep]
    return feat.to(torch.bfloat16), bin_windows(boxes, valid, 12, 17, 7, 7, 0.125), valid, rs


def test_check_passes_the_plain_version():
    feat, win, valid, rs = _check_inputs()
    assert bench.check({"plain": _plain_pool, "again": _plain_pool}, feat, win, valid, rs) == 0.0


def _one_bit_off(t):
    t = t.clone()
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    bits.view(-1)[7] ^= 1
    return t


@pytest.mark.parametrize("broken", ["out", "pos", "out without pos", "out without scale",
                                    "pos without pos"])
def test_check_catches_one_bit(broken):
    """One bit off in any of the four results, or a pos where none was asked
    for, fails the check."""
    feat, win, valid, rs = _check_inputs()

    def pool(feat, win, valid, rs, with_pos):
        out, pos = _plain_pool(feat, win, valid, rs, True)
        case = "out" if with_pos else "out without scale" if rs is None else "out without pos"
        if broken == case:
            out = _one_bit_off(out)
        if broken == "pos" and with_pos:
            pos = _one_bit_off(pos)
        return out, (pos if with_pos or broken == "pos without pos" else None)

    with pytest.raises(AssertionError, match="bad: "):
        bench.check({"bad": pool}, feat, win, valid, rs)


def _kernel_walk(feat, hs, he, ws, we, valid, row_scale, unroll, span):
    """The kernel's scan in Python: for every live bin, all channels at once
    (each lane does the same for its 16 bytes). ``span`` is the kernel's
    kSpan (0xffff); smaller values force the multi-chunk cases."""
    h, w, c = feat.shape
    p, ph_n = hs.shape
    pw_n = ws.shape[1]
    f = feat.float()
    out = torch.zeros((p, ph_n, pw_n, c), dtype=torch.float32)
    pos = torch.full((p, ph_n, pw_n, c), -1, dtype=torch.int32)
    for i in range(p):
        scale = 1.0 if row_scale is None else float(row_scale[i].to(feat.dtype))
        for a in range(ph_n):
            h0, h1 = int(hs[i, a]), int(he[i, a])
            for b in range(pw_n):
                w0, w1 = int(ws[i, b]), int(we[i, b])
                if not (valid[i] and h1 > h0 and w1 > w0):
                    continue
                best = f[h0, w0].clone()
                arg = torch.full((c,), h0 * w + w0, dtype=torch.int32)
                nh, nw = h1 - h0, w1 - w0
                n = nh * nw
                rows = nh if (nh - 1) * w + nw <= span else \
                    (span - nw) // w + 1 if nw <= span else 0
                y, x = h0, w0 + 1
                if x == w1:
                    x, y = w0, y + 1
                base = 0
                while base < n:
                    size = rows * nw if rows else min(span, nw - base % nw)
                    end = min(base + size, n)
                    first = (h0 + base // nw) * w + w0 + base % nw
                    off = torch.full((c,), span, dtype=torch.int64)   # 16-bit offsets
                    for start in range(max(base, 1), end, unroll):
                        batch = []
                        for k in range(unroll):      # the loads, clamped past the end
                            cell = min(y, h1 - 1) * w + x
                            batch.append((cell, f[cell // w, cell % w]))
                            if start + k < end:
                                x += 1
                                if x == w1:
                                    x, y = w0, y + 1
                        for k, (cell, v) in enumerate(batch):   # the compares, in order
                            if start + k < end:
                                assert 0 < cell - first < span or (cell - first == 0 and base)
                                take = v > best
                                best = torch.where(take, v, best)
                                off = torch.where(take, torch.tensor(cell - first), off)
                    arg = torch.where(off != span, (first + off).to(torch.int32), arg)
                    base = end
                out[i, a, b] = best * scale
                pos[i, a, b] = arg
    return out.to(feat.dtype), pos


@pytest.mark.parametrize("span", [0xffff, 40, 7])
@pytest.mark.parametrize("unroll", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_window_walk_equals_the_plain_version(span, unroll, dtype):
    """Windows of 1 to ~25 cells, single rows and columns, ties and invalid
    slots: the batched, chunked walk gives the plain version's out and pos
    (span 40: chunks of whole rows; span 7: pieces of one row too)."""
    rng = np.random.RandomState(7)
    h, w, c, p = 12, 15, 3, 9
    feat = torch.from_numpy(np.round(rng.randn(h, w, c) * 2).astype(np.float32)).to(dtype)
    boxes = np.stack([rng.uniform(0, 80, p), rng.uniform(0, 60, p)], 1)
    boxes = np.concatenate([boxes, boxes + rng.uniform(0, 90, (p, 2))], 1).astype(np.float32)
    boxes[0] = [0, 0, 119, 95]         # whole map
    boxes[1] = [40, 8, 40, 90]         # one column
    boxes[2] = [3, 50, 110, 50]        # one row
    boxes = torch.from_numpy(boxes)
    valid = torch.from_numpy(rng.rand(p) > 0.15)
    rs = torch.from_numpy(rng.uniform(1, 2, p).astype(np.float32))
    win = bin_windows(boxes, valid, h, w, 3, 2, 0.125)   # large bins: multi-chunk at span 7
    for scale in (None, rs):
        out_e, pos_e = _kernel_walk(feat, *win, valid, scale, unroll, span)
        out_p, pos_p = roi_pool_reference(feat, *win, valid, scale)
        assert torch.equal(pos_e, pos_p)
        assert torch.equal(out_e, out_p)


@functools.lru_cache(maxsize=None)
def _pallas_case():
    """bf16 inputs the Pallas kernel takes (7 x 7 bins), on a map wide enough
    that a window row spans more than 7 cells, with the kernel's out and pos
    in interpret mode. Signed zeros are left out: the Pallas kernel's integer
    keys order -0 below +0, where torchvision's compare ties them."""
    rng = np.random.RandomState(7)
    h, w, c, p = 10, 60, 3, 9
    feat = np.round(rng.randn(h, w, c) * 2).astype(np.float32) + 0.0   # ties, no -0
    boxes = np.stack([rng.uniform(0, 400, p), rng.uniform(0, 60, p)], 1)
    boxes = np.concatenate([boxes, boxes + rng.uniform(0, 300, (p, 2))], 1).astype(np.float32)
    boxes[0] = [0, 0, 479, 79]         # whole map: windows of up to 10 cells a row
    valid = rng.rand(p) > 0.15
    rs = rng.uniform(1, 2, p).astype(np.float32)
    out, pos = _roi_pool_fused_fwd_impl(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(rs), spatial_scale=0.125, output_size=(7, 7), interpret=True)
    feat_t = torch.from_numpy(feat).to(torch.bfloat16)
    valid_t = torch.from_numpy(valid)
    win = bin_windows(torch.from_numpy(boxes), valid_t, h, w, 7, 7, 0.125)
    return (feat_t, win, valid_t, torch.from_numpy(rs),
            np.asarray(out, np.float32), np.asarray(pos))


@pytest.mark.parametrize("span", [0xffff, 40, 7])
@pytest.mark.parametrize("unroll", [1, 4])
def test_kernel_window_walk_equals_the_pallas_kernel_interpret(span, unroll):
    """The walk gives the Pallas kernel's bf16 out and first-hit pos (span
    40: one row a chunk; span 7: pieces of one row too)."""
    feat, win, valid, rs, out_pallas, pos_pallas = _pallas_case()
    out_e, pos_e = _kernel_walk(feat, *win, valid, rs, unroll, span)
    np.testing.assert_array_equal(pos_e.numpy(), pos_pallas)
    np.testing.assert_array_equal(out_e.float().numpy(), out_pallas)
