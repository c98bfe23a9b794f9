// Multi-level ROIAlign backward for Hopper (sm_90a): the gradient of
// csrc/roi_align_fwd.cu's function with respect to each level's features.
//
// Replaces XLA's autodiff of sos_wsod_tpu/ops/roi_align.py:52 roi_align (the
// transpose of its jnp.take gathers, a scatter-add into the map), as the JAX
// package takes it through models/roi_heads/standard.py:43
// multilevel_roi_align in the stage-2 training step.
//
// What it computes (ops/roi_align.py:roi_align_levels_backward_reference,
// bit for bit). Each valid ROI p pools from its own level; bin (ph, pw) has
// a grid_h x grid_w sample grid, fixed by sampling_ratio or adaptive
// (ceil(bin size), capped at cap). Sample row iy reads rows lo and hi with
// factors h and l (axis_cells: +0 out of bounds), and likewise a column.
// For each channel c of each bin:
//   gc   = g[p, ph, pw, c] / count                  (a true division)
//   Y[y] = sum from +0, over iy ascending, of h where lo == y and l where
//          hi == y (the lo factor first)             X[x] likewise
//   term = (gc * Y[y]) * X[x]                        for each cell the bin touches
// and each cell's terms are added from +0 in ascending (p, ph, pw) order in
// f32, then rounded once to the features' dtype. Every product is rounded
// once (__fmul_rn) and every add once (__fadd_rn, never an FMA), so the
// result is the plain version's on the CPU, and the same from run to run.
// sample_pos and axis_cells are copies of roi_align_fwd.cu's
// (tests/test_torch_roi_align_grad.py holds them equal, text for text),
// with the same per-ROI scaled box, bin size, grid and count.
//
// What bounds it on this card: the bytes it must move are g read once and
// every level's gradient written once (at P = 512 and the 704 x 960 canvas in
// bf16, 12.8 + 28.7 MB, 12 us at 3.35 TB/s). This design reads a bin's g
// row once for each tile row its samples touch (about 2 tiles and 3 rows a
// live bin at 8 x 8 tiles, from L2), and writes the maps once. What limits
// it is the instructions of the walk: each (bin, tile row) costs a lane a
// true division, a product and 2 x 8 products and adds for each of its
// channels, where the bin touches 3 columns on average; the filling warp's
// test of every ROI of the level and its tables; and the tiles of p4 and p5
// that lie under many ROIs (the busiest 8 x 8 tile of the training inputs
// takes 5 times the mean tile's terms), which start first.
//
// Design:
//   - A block owns a tile of kTileH x kTileW cells of one level and 32 x
//     kVec channels of it (32 where the channel count is not a multiple of
//     kVec; the slices of a tile are neighbouring blocks, the tiles of the
//     coarsest level first), sums it in f32 registers and writes it once,
//     in the features' dtype, zeros where no ROI reaches. No atomics, no
//     zeroed buffer, no cast pass: the wrapper allocates the output with
//     torch.empty. Shared memory is a constant of the build (sizeof(Smem)).
//   - Each (cell, channel) has one owner thread: a warp owns a row of the
//     tile, a lane kVec channels of its kTileW cells.
//   - One more warp a block, the filling warp, tests the ROIs of the level
//     against the tile (first from the scaled box alone; then, for the few
//     that pass, from the extreme samples, which bound a ROI's cells:
//     positions are monotone in the bin and the sample), and for each ROI
//     that meets it computes, one lane a table, the bins' row tables (Y of
//     each row of the tile) and column tables (X of each column), once for
//     all channels. It queues the bins whose rows and columns both meet the
//     tile, in ascending (p, ph, pw) order, into two queues in turns, with
//     each tile row's list of the bins that touch it; named barriers hand a
//     queue to the adding warps and back, so the tables of the next ROIs
//     are computed while the adding warps add.
//   - An adding warp walks its row's list of each queue in order. A lane
//     copies its channels' g of the list's bins kDepth bins ahead into a
//     ring in shared memory (cp.async: no register waits on the copy); for
//     each bin it forms gc, t = gc * Y of its row, and adds t * X to each of
//     its cells: a column the bin does not touch has X = +0, which adds a
//     zero to a sum that started from +0, unless t is not finite.
//   - kTileH, kTileW and kDepth were chosen by a sweep
//     (sos_wsod_torch/tools/bench_roi_align.py --kernel bwd --sweep, PERF.md
//     section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;       // output tile rows: one adding warp each
constexpr int kTileW = 8;       // output tile columns
constexpr int kVec = 4;         // channels a lane, where the channel count and addresses allow
constexpr int kDepth = 4;       // bins whose g a lane has in flight
constexpr int kQueue = 256;     // bins a queue holds
constexpr int kTables = 64;     // row and column tables a queue holds
constexpr int kRois = 4;        // ROIs a lane of the filling warp tests at a time
constexpr int kMaxLevels = 8;
constexpr int kMaxBins = 16;    // output rows (and columns) at most: a ROI's tables fit a warp
constexpr int kMaxCap = 4096;   // samples a side at most: the count stays an exact f32
constexpr int kThreads = kTileH * 32 + 32;   // the adding warps and the filling warp
constexpr int kMinBlocks = 864 / kThreads;   // blocks an SM holds: 27 warps, under 76 registers
constexpr int kTileMax = kTileH > kTileW ? kTileH : kTileW;

static_assert(kQueue >= 32 * kMaxBins * kMaxBins / (2 * kMaxBins), "a pass's bins fit a queue");
static_assert(kTables >= 32, "a pass's tables fit a queue");

// The levels in the order of the blocks: the coarsest first, whose tiles
// take the most terms (a p4 or p5 cell lies under many ROIs' bins).
struct Levels {
  int id[kMaxLevels];         // the level's index
  int64_t base[kMaxLevels];   // its first cell in the output
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int tile0[kMaxLevels];      // its first tile
  int tiles_x[kMaxLevels];
};

// One sample row (or column): its two cells and its two weight factors,
// +0 when out of bounds.
struct Axis {
  int lo, hi;
  float l, h;
};

// A bin's row (or column) table in the tile: Y (or X) of each row (column)
// of the tile, +0 where the bin's samples touch none, and the mask of those
// they touch.
struct alignas(16) Tab {
  float v[kTileMax];
  unsigned mask;
};

// A ROI of the level whose samples meet the tile.
struct Hit {
  int p, grid_h, grid_w;
  float count, y1, bin_h, x1, bin_w;
};

struct Smem {
  uint4 ring[kTileH][kDepth][32];   // each lane's g of its next bins, kVec channels
  int4 bin[2][kQueue];          // (g row p * PH * PW + ph * PW + pw, row table, column table, count)
  Tab tab[2][kTables];
  Hit hit[32 * kRois];          // the filling warp's ROIs that meet the tile, in order
  float4 box[32 * kRois];       // the filling warp's ROIs being tested
  int lvl[32 * kRois];          // and their levels, -1 where invalid
  int cand[32 * kRois];         // those whose scaled boxes pass axis_may_meet, in order
  int binpos[kMaxBins * kMaxBins];   // bin b's (ph << 8 | pw)
  int16_t rows[2][kTileH][kQueue];   // each tile row's bins, as places in the queue
  int rlen[2][kTileH];          // and their number
  int last[2];                  // whether the queue is the walk's last
};

// Named barriers (0 is __syncthreads', unused here): the filling warp
// arrives at kFull + b when queue b is filled and waits at kFree + b until
// the adding warps, which wait at kFull + b, have arrived there after adding
// it. Every use counts all kThreads threads.
constexpr int kFull = 1, kFree = 3;

template <int kId>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kThreads) : "memory");
}

template <int kId>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"n"(kId), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void wait_full(int q) { q ? bar_sync<kFull + 1>() : bar_sync<kFull>(); }
__device__ __forceinline__ void wait_free(int q) { q ? bar_sync<kFree + 1>() : bar_sync<kFree>(); }
__device__ __forceinline__ void mark_full(int q) {
  q ? bar_arrive<kFull + 1>() : bar_arrive<kFull>();
}
__device__ __forceinline__ void mark_free(int q) {
  q ? bar_arrive<kFree + 1>() : bar_arrive<kFree>();
}

// Sample i of bin p along one axis: (start + p * bin) + ((i + 0.5) / g) * bin.
__device__ __forceinline__ float sample_pos(float start, float bin, int g, int p, int i) {
  const float frac = __fdiv_rn((float)i + 0.5f, (float)g);
  return __fadd_rn(__fadd_rn(start, __fmul_rn((float)p, bin)), __fmul_rn(frac, bin));
}

// _bilinear_weights along one axis of n cells: the two cells and the
// factors (l, 1 - l), both +0 when the position is out of bounds.
__device__ __forceinline__ Axis axis_cells(float v, int n) {
  const bool oob = (v < -1.f) || (v > (float)n);
  v = v < 0.f ? 0.f : v;   // clip(min=0): NaN stays NaN
  Axis a;
  a.lo = min((int)v, n - 1);
  a.hi = min(a.lo + 1, n - 1);
  if (a.lo >= n - 1) v = (float)(n - 1);
  const float l = __fsub_rn(v, (float)a.lo);
  a.l = oob ? 0.f : l;
  a.h = oob ? 0.f : __fsub_rn(1.f, l);
  return a;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x % 32)) - 1u;
}

// The ROI's quantities, in the forward's f32 operations.
__device__ __forceinline__ Hit roi_geometry(int p, float4 b, float scale, int aligned, int ph_out,
                                            int pw_out, int sampling_ratio, int cap) {
  const float offset = aligned ? 0.5f : 0.f;
  const float x1 = __fsub_rn(__fmul_rn(b.x, scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(b.y, scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(b.z, scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(b.w, scale), offset);
  float roi_w = __fsub_rn(x2, x1);
  float roi_h = __fsub_rn(y2, y1);
  if (!aligned) {
    roi_w = roi_w < 1.f ? 1.f : roi_w;
    roi_h = roi_h < 1.f ? 1.f : roi_h;
  }
  const float bin_h = __fdiv_rn(roi_h, (float)ph_out);
  const float bin_w = __fdiv_rn(roi_w, (float)pw_out);
  int grid_h = sampling_ratio, grid_w = sampling_ratio;
  if (sampling_ratio <= 0) {
    grid_h = min(max((int)ceilf(bin_h), 1), cap);
    grid_w = min(max((int)ceilf(bin_w), 1), cap);
  }
  Hit r;
  r.p = p;
  r.grid_h = grid_h;
  r.grid_w = grid_w;
  r.count = (float)max(grid_h * grid_w, 1);
  r.y1 = y1;
  r.bin_h = bin_h;
  r.x1 = x1;
  r.bin_w = bin_w;
  return r;
}

// Whether the cells of a ROI's samples along one axis can meet [t0, t0 +
// kt), from its scaled ends a and b alone. Every sample lies between the
// ends, or up to 1 past them for ROIAlign V1's size of at least 1, within
// rounding below 1/8 for ends under 2^20 in magnitude; so its cells lie in
// [cell(min - 1), cell(max + 3)] (axis_cells' cells are monotone in the
// position). Other ends, and NaN, always pass.
__device__ __forceinline__ bool axis_may_meet(float a, float b, int n, int t0, int kt) {
  if (!(fabsf(a) < 1048576.f && fabsf(b) < 1048576.f)) return true;
  const int c0 = min((int)fmaxf(fminf(a, b) - 1.f, 0.f), n - 1);
  const int c1 = min((int)fmaxf(fmaxf(a, b) + 3.f, 0.f), n - 1);
  return c0 < t0 + kt && c1 >= t0;
}

// Whether the cells of the ROI's samples along one axis meet [t0, t0 + kT).
// A sample's position is monotone in its bin and in its index within the
// bin (each rounded step is), so the first sample of the first bin and the
// last of the last bound every sample, and axis_cells is monotone too.
__device__ __forceinline__ bool axis_meets(float start, float bin, int g, int bins, int n,
                                           int t0, int kt) {
  const float a = sample_pos(start, bin, g, 0, 0), b = sample_pos(start, bin, g, bins - 1, g - 1);
  const Axis lo = axis_cells(fminf(a, b), n), hi = axis_cells(fmaxf(a, b), n);
  return lo.lo < t0 + kt && hi.hi >= t0;
}

// One bin's table along one axis, restricted to the tile's cells [t0, t0 +
// kt): Y of each cell in its sum's order (samples ascending, the lo factor
// first), and the cells as a mask.
__device__ __forceinline__ unsigned axis_table(float start, float bin, int g, int b, int n, int t0,
                                               int kt, float* sum) {
#pragma unroll
  for (int k = 0; k < kTileMax; ++k) sum[k] = 0.f;
  unsigned mask = 0;
  for (int i = 0; i < g; ++i) {
    const Axis a = axis_cells(sample_pos(start, bin, g, b, i), n);
    const int lo = a.lo - t0, hi = a.hi - t0;
#pragma unroll
    for (int k = 0; k < kTileMax; ++k) {
      if (lo == k) sum[k] = __fadd_rn(sum[k], a.h);
    }
#pragma unroll
    for (int k = 0; k < kTileMax; ++k) {
      if (hi == k) sum[k] = __fadd_rn(sum[k], a.l);
    }
    if ((unsigned)lo < (unsigned)kt) mask |= 1u << lo;
    if ((unsigned)hi < (unsigned)kt) mask |= 1u << hi;
  }
  return mask;
}

// The filling warp: queues, in turns in the two queues, the bins of the
// level's ROIs whose rows and columns meet the tile, in ascending (p, ph,
// pw) order, with their tables. Its lanes test kRois x 32 ROIs at a time,
// all loads issued together (first from the scaled box alone, then, for
// the few that pass, from their extreme samples), and list the ROIs that
// meet the tile in order; then a pass takes 32 / (PH + PW) listed ROIs,
// one lane a table (row tables of ph, then column tables of pw), places the
// non-empty tables by a prefix sum over the lanes, and places the bins
// whose two tables are non-empty the same way. A queue that could not take
// a whole pass is handed over first.
__device__ __forceinline__ void fill(Smem& s, int l, int num_levels, int h, int w, float scale,
                                     const float4* boxes, const int* level, const bool* valid,
                                     int P, int PH, int PW, int sampling_ratio, int cap,
                                     int aligned, int ty0, int tx0) {
  const int lane = threadIdx.x % 32;
  const int per = PH + PW, group = 32 / per, bins = PH * PW;
  int r = 0, nb = 0, nt = 0;   // the round (queue r & 1), its bins and tables so far
  int rl[kTileH];               // and the bins of each tile row
#pragma unroll
  for (int k = 0; k < kTileH; ++k) rl[k] = 0;
  for (int i = lane; i < bins; i += 32) s.binpos[i] = (i / PW) << 8 | (i % PW);
  __syncwarp();
  auto hand_over = [&](bool last) {
    if (lane == 0) s.last[r & 1] = last;
#pragma unroll
    for (int k = 0; k < kTileH; ++k) {
      if (lane == k) s.rlen[r & 1][k] = rl[k];
      rl[k] = 0;
    }
    __syncwarp();
    __threadfence_block();
    mark_full(r & 1);
    ++r;
    nb = nt = 0;
    if (!last && r >= 2) wait_free(r & 1);   // the adding warps are done with round r - 2
  };
  const float offset = aligned ? 0.5f : 0.f;
  for (int p0 = 0; p0 < P; p0 += 32 * kRois) {
    // the ROIs' levels and boxes, kRois x 32 at a time, all loads issued
    // together, staged in shared memory
#pragma unroll
    for (int j = 0; j < kRois; ++j) {
      const int p = p0 + 32 * j + lane;
      s.lvl[32 * j + lane] = p < P && valid[p] ? min(max(level[p], 0), num_levels - 1) : -1;
      s.box[32 * j + lane] = p < P ? boxes[p] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    // the candidates: the ROIs of the level whose scaled boxes may meet the
    // tile, in order; then their exact test, one a lane
    int nc = 0;
    for (int j = 0; j < kRois; ++j) {
      const float4 b = s.box[32 * j + lane];
      const bool may = s.lvl[32 * j + lane] == l &&
                       axis_may_meet(__fsub_rn(__fmul_rn(b.y, scale), offset),
                                     __fsub_rn(__fmul_rn(b.w, scale), offset), h, ty0, kTileH) &&
                       axis_may_meet(__fsub_rn(__fmul_rn(b.x, scale), offset),
                                     __fsub_rn(__fmul_rn(b.z, scale), offset), w, tx0, kTileW);
      const unsigned m = __ballot_sync(0xffffffffu, may);
      if (may) s.cand[nc + __popc(m & lanes_below())] = 32 * j + lane;
      nc += __popc(m);
    }
    __syncwarp();
    int nh = 0;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      bool hit = false;
      Hit g;
      if (c0 + lane < nc) {
        const int k = s.cand[c0 + lane];
        g = roi_geometry(p0 + k, s.box[k], scale, aligned, PH, PW, sampling_ratio, cap);
        hit = axis_meets(g.y1, g.bin_h, g.grid_h, PH, h, ty0, kTileH) &&
              axis_meets(g.x1, g.bin_w, g.grid_w, PW, w, tx0, kTileW);
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) s.hit[nh + __popc(m & lanes_below())] = g;
      nh += __popc(m);
    }
    __syncwarp();
    for (int h0 = 0; h0 < nh; h0 += group) {
      const int nroi = min(group, nh - h0);
      if (nt + nroi * per > kTables || nb + nroi * bins > kQueue) hand_over(false);
      const int q = r & 1;
      // the tables: lane k * per + t, ROI h0 + k, row table t or column table t - PH
      const int k = lane / per, t = lane - k * per;
      float sum[kTileMax];
      unsigned mask = 0;
      if (k < nroi) {
        const Hit& g = s.hit[h0 + k];
        const bool row = t < PH;
        mask = axis_table(row ? g.y1 : g.x1, row ? g.bin_h : g.bin_w, row ? g.grid_h : g.grid_w,
                          row ? t : t - PH, row ? h : w, row ? ty0 : tx0,
                          row ? kTileH : kTileW, sum);
      }
      const unsigned live = __ballot_sync(0xffffffffu, mask != 0);
      const int slot = nt + __popc(live & lanes_below());
      if (mask) {
        Tab& tb = s.tab[q][slot];
#pragma unroll
        for (int c = 0; c < kTileMax; ++c) tb.v[c] = sum[c];
        tb.mask = mask;
      }
      nt += __popc(live);
      // the bins of each ROI of the pass, 32 at a time
      for (int kk = 0; kk < nroi; ++kk) {
        const Hit& g = s.hit[h0 + kk];
        for (int i0 = 0; i0 < bins; i0 += 32) {
          const int i = i0 + lane;
          const int pos = i < bins ? s.binpos[i] : 0, ph = pos >> 8, pw = pos & 255;
          const int src_r = kk * per + ph, src_c = kk * per + PH + pw;
          const unsigned mr = __shfl_sync(0xffffffffu, mask, src_r);
          const unsigned mc = __shfl_sync(0xffffffffu, mask, src_c);
          const int sr = __shfl_sync(0xffffffffu, slot, src_r);
          const int sc = __shfl_sync(0xffffffffu, slot, src_c);
          const bool on = i < bins && mr != 0 && mc != 0;
          const unsigned m = __ballot_sync(0xffffffffu, on);
          const int at = nb + __popc(m & lanes_below());
          if (on) s.bin[q][at] = make_int4(g.p * bins + i, sr, sc, __float_as_int(g.count));
          nb += __popc(m);
#pragma unroll
          for (int k = 0; k < kTileH; ++k) {   // the bin's place in the lists of its rows
            const bool in = on && (mr >> k & 1u);
            const unsigned mk = __ballot_sync(0xffffffffu, in);
            if (in) s.rows[q][k][rl[k] + __popc(mk & lanes_below())] = (int16_t)at;
            rl[k] += __popc(mk);
          }
        }
      }
    }
    __syncwarp();   // s.hit, s.cand and the staged ROIs are rewritten by the next ROIs
  }
  hand_over(true);
  // wait for the adds of the last two rounds, so that every arrival at a
  // kFree barrier has its wait
  for (int rr = max(r - 2, 0); rr < r; ++rr) wait_free(rr & 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies kVec channels of g, 4 x kVec bytes of f32 or 2 x kVec of bf16, into
// the lane's ring slot, without holding a register.
template <typename T>
__device__ __forceinline__ void copy_g(void* dst, const T* src) {
  if constexpr (sizeof(T) * kVec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_f32(p[k]);
}

// One bin's terms for the warp's tile row r: gc = g / count for each of the
// lane's channels, t = gc * Y, then t * X onto each column. A column the
// bin does not touch has X = +0, and a finite t adds a zero there, which
// leaves the sum as it is (a sum from +0 is never -0); a t that is not
// finite adds only to the columns the bin touches.
template <int V>
__device__ __forceinline__ void add_bin(float (&acc)[V][kTileW], const float* g, float count,
                                        float y, const Tab& cx) {
  float t[V], x[kTileW];
  bool finite = true;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    t[k] = __fmul_rn(__fdiv_rn(g[k], count), y);
    finite = finite && isfinite(t[k]);
  }
#pragma unroll
  for (int c = 0; c < kTileW; ++c) x[c] = cx.v[c];
  if (finite) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int c = 0; c < kTileW; ++c) acc[k][c] = __fadd_rn(acc[k][c], __fmul_rn(t[k], x[c]));
    }
  } else {
    const unsigned m = cx.mask;
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int c = 0; c < kTileW; ++c) {
        if (m >> c & 1u) acc[k][c] = __fadd_rn(acc[k][c], __fmul_rn(t[k], x[c]));
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) roi_align_bwd_kernel(
    Levels lv, int num_levels, int C, const float4* __restrict__ boxes,
    const int* __restrict__ level, const bool* __restrict__ valid, int P, int PH, int PW,
    int sampling_ratio, int cap, int aligned, int slices, const T* __restrict__ grad,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  // block = tile * slices + slice: the slices of a tile run side by side
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  // the tile's level, picked with constant indices: indexing the parameter
  // arrays with l would copy them to local memory
  int l = lv.id[0];
  int64_t base = lv.base[0];
  int h = lv.h[0], w = lv.w[0], tile0 = lv.tile0[0], tiles_x = lv.tiles_x[0];
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < num_levels && tile >= lv.tile0[i]) {
      l = lv.id[i];
      base = lv.base[i];
      h = lv.h[i];
      w = lv.w[i];
      tile0 = lv.tile0[i];
      tiles_x = lv.tiles_x[i];
      scale = lv.scale[i];
    }
  }
  const int t = tile - tile0;
  const int ty0 = t / tiles_x * kTileH, tx0 = t % tiles_x * kTileW;
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r == kTileH) {
    fill(s, l, num_levels, h, w, scale, boxes, level, valid, P, PH, PW, sampling_ratio, cap,
         aligned, ty0, tx0);
    return;
  }
  // the warp owns tile row r, the lane channels ch .. ch + V - 1 of it
  const int ch = slice * 32 * V + lane * V;
  const bool live = ch < C;
  float acc[V][kTileW];
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int c = 0; c < kTileW; ++c) acc[k][c] = 0.f;
  }

  // each warp walks its row's list of each queue in order; with kVec
  // channels a lane it copies their g kDepth bins ahead
  for (int rd = 0;; ++rd) {
    const int q = rd & 1;
    wait_full(q);
    const int n = s.rlen[q][r];
    const bool last = s.last[q] != 0;
    const int16_t* list = s.rows[q][r];
    const int4* bins = s.bin[q];
    const Tab* tabs = s.tab[q];
    auto issue = [&](int j) {
      if (j < n && live)
        copy_g(&s.ring[r][j % kDepth][lane], grad + (int64_t)bins[list[j]].x * C + ch);
      copy_commit();
    };
    if constexpr (V == kVec) {
#pragma unroll
      for (int j = 0; j < kDepth - 1; ++j) issue(j);
    }
    for (int j = 0; j < n; ++j) {
      if constexpr (V == kVec) {
        issue(j + kDepth - 1);
        copy_wait<kDepth - 1>();
      }
      const int4 b = bins[list[j]];
      float g[V];
      if constexpr (V == kVec)
        load_vec<T, V>(reinterpret_cast<const T*>(&s.ring[r][j % kDepth][lane]), g);
      else
        g[0] = live ? to_f32(grad[(int64_t)b.x * C + ch]) : 0.f;
      add_bin<V>(acc, g, __int_as_float(b.w), tabs[b.y].v[r], tabs[b.z]);
    }
    if constexpr (V == kVec) copy_wait<0>();
    __syncwarp();
    __threadfence_block();
    mark_free(q);
    if (last) break;
  }

  // the owner writes its cells, zeros included
  if (live && ty0 + r < h) {
    T* o = out + (base + (int64_t)(ty0 + r) * w + tx0) * C + ch;
#pragma unroll
    for (int c = 0; c < kTileW; ++c) {
      if (tx0 + c < w) {
#pragma unroll
        for (int k = 0; k < V; ++k) store(o + (int64_t)c * C + k, acc[k][c]);
      }
    }
  }
}

template <typename T, int V>
int launch(const Levels& lv, int num_levels, int tiles, int C, const void* boxes,
           const void* level, const void* valid, int P, int PH, int PW, int sampling_ratio,
           int cap, int aligned, const void* grad, void* out, cudaStream_t stream) {
  const int slices = (C + 32 * V - 1) / (32 * V);
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  roi_align_bwd_kernel<T, V><<<(unsigned)((int64_t)tiles * slices), kThreads, smem, stream>>>(
      lv, num_levels, C, static_cast<const float4*>(boxes), static_cast<const int*>(level),
      static_cast<const bool*>(valid), P, PH, PW, sampling_ratio, cap, aligned, slices,
      static_cast<const T*>(grad), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(const Levels& lv, int num_levels, int tiles, int C, const void* boxes,
               const void* level, const void* valid, int P, int PH, int PW, int sampling_ratio,
               int cap, int aligned, const void* grad, void* out, cudaStream_t stream) {
  const size_t align = sizeof(T) * kVec;
  const bool vec = C % kVec == 0 && (uintptr_t)grad % align == 0 && (uintptr_t)out % align == 0;
  return vec ? launch<T, kVec>(lv, num_levels, tiles, C, boxes, level, valid, P, PH, PW,
                               sampling_ratio, cap, aligned, grad, out, stream)
             : launch<T, 1>(lv, num_levels, tiles, C, boxes, level, valid, P, PH, PW,
                            sampling_ratio, cap, aligned, grad, out, stream);
}

}  // namespace

// The build's constants: tile rows, tile columns, channels a block (kVec
// a lane), threads a block, dynamic shared memory bytes a block, bins and
// tables a queue, output rows (and columns) at most, samples a side at
// most.
extern "C" void sos_roi_align_bwd_config(int* out) {
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = 32 * kVec;
  out[3] = kThreads;
  out[4] = (int)sizeof(Smem);
  out[5] = kQueue;
  out[6] = kTables;
  out[7] = kMaxBins;
  out[8] = kMaxCap;
}

// dtype 0 = float32, 1 = bfloat16: the type of grad and of the features.
// Levels hs[l] x ws[l] with spatial scales scales[l]; boxes (p, 4) f32, level
// (p,) int32 (clamped to [0, num_levels)), valid (p,) bool, grad (p, ph, pw,
// c), all contiguous. out: sum(hs * ws) * c elements of grad's dtype, the
// levels' (h, w, c) gradients after one another, every element of which the
// kernel writes. sampling_ratio > 0 fixes the grid, else it is ceil(bin)
// capped at cap. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sos_roi_align_bwd(int dtype, int num_levels, const int* hs, const int* ws,
                                 const float* scales, int c, const void* boxes, const void* level,
                                 const void* valid, int p, int ph, int pw, int sampling_ratio,
                                 int cap, int aligned, const void* grad, void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || c < 1 || ph < 1 || pw < 1 ||
      ph > kMaxBins || pw > kMaxBins || cap < 1 || cap > kMaxCap || p < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  int64_t base[kMaxLevels], cells = 0, tiles = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    base[l] = cells;
    cells += (int64_t)hs[l] * ws[l];
  }
  for (int i = 0; i < kMaxLevels; ++i) {   // block order: the coarsest level first
    const int k = i < num_levels ? num_levels - 1 - i : 0;
    lv.id[i] = k;
    lv.base[i] = base[k];
    lv.h[i] = hs[k];
    lv.w[i] = ws[k];
    lv.scale[i] = scales[k];
    lv.tile0[i] = (int)tiles;
    lv.tiles_x[i] = (ws[k] + kTileW - 1) / kTileW;
    if (i < num_levels) tiles += (int64_t)((hs[k] + kTileH - 1) / kTileH) * lv.tiles_x[i];
  }
  if (tiles * ((c + 31) / 32) > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vec<float>(lv, num_levels, (int)tiles, c, boxes, level, valid, p, ph, pw,
                             sampling_ratio, cap, aligned, grad, out, st);
  return launch_vec<__nv_bfloat16>(lv, num_levels, (int)tiles, c, boxes, level, valid, p, ph,
                                   pw, sampling_ratio, cap, aligned, grad, out, st);
}
