// Multi-level ROIAlign forward for Hopper (sm_90a).
//
// Replaces the XLA op sos_wsod_tpu/ops/roi_align.py:52 roi_align, as the JAX
// package runs it for the FPN box head through
// models/roi_heads/standard.py:43 multilevel_roi_align: every ROI pooled on
// every level under a mask, up to 8 x 8 samples a bin, each sample four
// gathers over the whole (P, 7, 7, C) tensor, then a masked sum of the
// levels. Here one launch pools every ROI from its own level only: the
// level index per ROI (assign_boxes_to_levels, computed in torch) picks the
// map, its size and its scale.
//
// Arithmetic: the plain version's, in the same order, each step rounded to
// nearest and never contracted into an FMA: scaled = box * scale - offset;
// bin = roi / 7; y = (y1 + ph * bin_h) + y_frac * bin_h with y_frac =
// (iy + 0.5) / grid_h; the clipping and out-of-bounds rules of
// _bilinear_weights (sos_wsod_tpu/ops/roi_align.py:23); a sample is
// ((((0 + f0 w0) + f1 w1) + f2 w2) + f3 w3), added to an f32 accumulator
// from +0 with iy outer and ix inner, then one divide by the sample count and
// one rounding to the output type. The rules are separable: a sample row
// gives its two rows and weights (ly, hy), a column its two columns and
// (lx, hx), and the corner weights are the products hy hx, hy lx, ly hx,
// ly lx. Out of bounds, the plain version's weight is +0; here the row's
// (or column's) two factors are set to +0 instead, and a product of +0 with
// a factor in [0, 1] is +0, the same bits. The plain version also adds
// sample x 0 for the samples outside a ROI's adaptive grid (up to the cap);
// those terms are +-0 and leave the sum as it is, so the kernel skips them.
// The result equals the plain version bit for bit wherever the feature maps
// are finite. Invalid ROIs give +0.
//
// What bounds it. The bytes the function must move are the maps read once
// and the output written once: at the FPN inputs of tools/bench_roi_align.py
// (p2-p5 of a 704 x 960 canvas x 256, 1000 ROIs) 28.7 MB + 25.1 MB in bf16,
// 16 us at 3.35 TB/s. Its arithmetic is fixed: 9 f32 operations a
// sample-channel (4 products, 4 adds, the accumulate), 884 M operations for
// the 383,719 samples of those inputs, 13 us at 67 TFLOP/s. Far from both,
// the kernel is bound by instruction issue: a bf16 channel costs 4
// conversions and the 9 operations a sample, and every instruction spent
// on addresses, divides, copies or waiting lanes comes on top. The earlier
// design (a warp a bin, every corner loaded from the map through L1) spent
// about 170 instructions a warp a sample for 8 bf16 channels a lane: two
// IEEE divides, the bilinear rules and 64-bit addresses for each sample.
//
// Design: one block a ROI and kSlicesPerBlock of its channel slices of
// kSliceBytes (64 bf16 or 32 f32 channels).
//  1. The block's first 2 x kTable threads each compute one table entry, a
//     sample row's (or column's) two cells and weight factors: one divide
//     a row or column, not one a sample. The window, the rows [y0, y1] and
//     columns [x0, x1] that bilinear reads (clipped as it clips,
//     out-of-bounds samples included), is their extremes, by warp
//     reductions and one barrier.
//  2. Staged branch, when the tables hold the ROI's sample rows and columns
//     and the window fits the buffer: the block copies the window's slice
//     into shared memory with 16-byte cp.async copies (a thread keeps its
//     column and steps two addresses from row to row), in cells of 128
//     bytes where they fit, else of 64. A window of at most half the buffer
//     gets two: the next slice is copied in while this one is computed.
//     Then 4 lanes a bin walk its samples from the tables, each lane two
//     16-byte chunks of the cell, the four corners from shared memory at
//     32-bit offsets, the bin's output written once. Bank conflicts: the
//     two bins of a quarter-warp read different cells; a bin of odd index
//     reads its lane's chunks in the other order, so that in each load one
//     bin takes the even 16-byte chunks of its 128-byte cell and the other
//     the odd ones, which lie in disjoint banks whatever the cells. The
//     column table's rows have an odd length for the same reason.
//  3. Direct branch, otherwise: the same walk reads the corners straight
//     from the map, with the sample's rows and columns computed in the
//     loop, as the earlier design did. It is for what the FPN head does not
//     give: a whole-map ROI on a large map, a large sample cap or fixed
//     sampling ratio, a ROI across nearly the whole width of p2.
//  The branch is decided from the ROI's own quantities, the same in every
//  thread of its block, with no host sync. There are no atomics: each
//  thread writes its own outputs, the same bits every run.
//
// Footprint. kBufferBytes of window (73,728 bytes: 576 cells of 128 bytes,
// or 1,152 of 64), two tables of kTable 16-byte entries and the warps'
// window extremes, 75,904 bytes a block: three blocks on an SM (228 KB),
// and three of 256 threads at 80 registers fill its registers. Why 1,152
// cells hold nearly every ROI of the FPN head at the 704 x 960 canvas:
// assign_boxes_to_levels puts a ROI on level k < 5 only when sqrt(area) <
// 224 * 2^(k-3), so on its own level (scale 2^-k) its area is under 784
// cells; its window is at most (ceil(h) + 1) x (ceil(w) + 1) cells with
// h * w < 784 and w at most the map's width: at most 1,175 cells at that
// canvas, more than 1,152 only for ROIs lying across nearly the whole width
// of p2, a few cells tall (tests/test_torch_roi_align_plan.py), which take
// the direct branch; 1,065 at the benchmark's inputs, all staged. p5, the
// clamped top level, is at most its whole map: 22 x 30 cells. The launch
// plan, kernels/roi_align.py:launch_plan, mirrors the constants.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;        // channels a thread reads at a time, in bytes
constexpr int kMaxLevels = 8;
constexpr int kSliceBytes = 128;     // a block's channel slice: 64 bf16 or 32 f32 channels
constexpr int kBufferBytes = 73728;  // the window buffer: 576 cells of 128 bytes, 1,152 of 64
constexpr int kTable = 64;           // sample rows (and columns) a table holds
constexpr int kBlocksPerSm = 3;
constexpr int kSlicesPerBlock = 2;   // channel slices of one ROI a block takes in turn

static_assert(2 * kTable <= kThreads, "one thread a table entry");

struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// One sample row (or column): its two cells, as byte offsets into the
// staged window, and its two weight factors, +0 when out of bounds.
struct Axis {
  int lo, hi;
  float l, h;
};

struct Smem {
  alignas(128) Axis ys[kTable];
  Axis xs[kTable];
  int bounds[kThreads / 32][4];   // each warp's window extremes
  alignas(128) unsigned char window[kBufferBytes];
};
static_assert(kBlocksPerSm * (sizeof(Smem) + 1024) <= 233472, "blocks an SM's shared memory holds");

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// N elements of T, to N floats and back: one load or store of N * sizeof(T)
// bytes (16, 8, 4 or 2), from the map (read-only path) or shared memory.
template <int W>
__device__ __forceinline__ void ldg_words(const void* p, uint32_t* u) {
  if constexpr (W == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
  } else if constexpr (W == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    u[0] = q.x; u[1] = q.y;
  } else {
    u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

template <int W>
__device__ __forceinline__ void lds_words(uint32_t a, uint32_t* u) {
  if constexpr (W == 4) {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3]) : "r"(a));
  } else if constexpr (W == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(u[0]), "=r"(u[1]) : "r"(a));
  } else {
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(u[0]) : "r"(a));
  }
}

template <typename T, int N>
struct Vec {
  static constexpr int kWords = N * (int)sizeof(T) / 4;   // 0: a single bf16
  __device__ static void unpack(const uint32_t* u, float* v) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __uint_as_float(u[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) { v[2 * i] = bf16_lo(u[i]); v[2 * i + 1] = bf16_hi(u[i]); }
    }
  }
  __device__ static void load(const T* p, float* v) {
    if constexpr (kWords == 0) {
      v[0] = __bfloat162float(p[0]);
    } else {
      uint32_t u[kWords];
      ldg_words<kWords>(p, u);
      unpack(u, v);
    }
  }
  __device__ static void load_shared(uint32_t a, float* v) {
    if constexpr (kWords == 0) {
      unsigned short x;
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(x) : "r"(a));
      v[0] = __uint_as_float((uint32_t)x << 16);
    } else {
      uint32_t u[kWords];
      lds_words<kWords>(a, u);
      unpack(u, v);
    }
  }
  __device__ static void store(T* p, const float* v) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (N == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else if constexpr (N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      } else {
        p[0] = v[0];
      }
    } else if constexpr (N == 1) {
      p[0] = __float2bfloat16_rn(v[0]);
    } else {
      uint32_t u[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const __nv_bfloat162 q = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&q);
      }
      if constexpr (N == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
      } else if constexpr (N == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
      } else {
        *reinterpret_cast<uint32_t*>(p) = u[0];
      }
    }
  }
};

// acc += ((((0 + f0 w0) + f1 w1) + f2 w2) + f3 w3), channel by channel.
template <int N>
__device__ __forceinline__ void add_sample(float* acc, const float* f0, const float* f1,
                                           const float* f2, const float* f3, const float* wt) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = __fadd_rn(0.f, __fmul_rn(f0[i], wt[0]));
    s = __fadd_rn(s, __fmul_rn(f1[i], wt[1]));
    s = __fadd_rn(s, __fmul_rn(f2[i], wt[2]));
    s = __fadd_rn(s, __fmul_rn(f3[i], wt[3]));
    acc[i] = __fadd_rn(acc[i], s);
  }
}

__device__ __forceinline__ void weights(const Axis& ya, const Axis& xa, float* wt) {
  wt[0] = __fmul_rn(ya.h, xa.h);
  wt[1] = __fmul_rn(ya.h, xa.l);
  wt[2] = __fmul_rn(ya.l, xa.h);
  wt[3] = __fmul_rn(ya.l, xa.l);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the window's rows [0, wh) x cols [0, ww) of channels [c0, c0 + sc)
// from src (the window's first cell at channel c0, row stride w cells) to
// the shared buffer at dst, cell bytes a cell and ww cells a row: 16-byte
// cp.async chunks, or (one channel a thread) element by element. A thread
// keeps its column and chunk from row to row and steps its two addresses.
template <typename T, int CHUNK>
__device__ __forceinline__ void stage(const T* src, int w, int c, int wh, int ww, int cell,
                                      int sc, unsigned char* dst, int tid) {
  const int cpc = (sc + CHUNK - 1) / CHUNK;          // chunks a cell
  const int row_chunks = ww * cpc;
  const uint32_t base = smem_addr(dst);
  const int64_t src_row = (int64_t)w * c;
  const int dst_row = ww * cell;
  // rows [r0, wh) step rstep, the chunk k of each
  auto rows = [&](int r0, int rstep, int k) {
    const int col = k / cpc, part = k - col * cpc;
    const T* s = src + (int64_t)r0 * src_row + (int64_t)col * c + part * CHUNK;
    uint32_t d = base + r0 * dst_row + col * cell + part * CHUNK * (int)sizeof(T);
    const int64_t s_step = rstep * src_row;
    const int d_step = rstep * dst_row;
    for (int r = r0; r < wh; r += rstep, s += s_step, d += d_step) {
      if constexpr (CHUNK * sizeof(T) == 16) {
        cp_async16(d, s);
      } else {
        *reinterpret_cast<T*>(dst + (d - base)) = s[0];
      }
    }
  };
  if (row_chunks <= kThreads) {
    const int rstep = kThreads / row_chunks, r0 = tid / row_chunks;
    if (r0 < rstep) rows(r0, rstep, tid - r0 * row_chunks);
  } else {
    for (int k = tid; k < row_chunks; k += kThreads) rows(0, 1, k);
  }
}

// One unit of channels of a staged window: every bin of the ROI, PARTS
// lanes a bin, NCH chunks of VEC channels a lane, the corners read from the
// window at win through the tables. With two chunks a lane (128-byte
// cells), a bin of odd index reads its chunks in the other order: the two
// bins of a quarter-warp then read the even and the odd 16-byte chunks of
// their cells, which lie in disjoint banks, whatever the cells. uc: the
// unit's channels; o: the output at the unit's first channel.
template <typename T, int VEC, int NCH, int PARTS>
__device__ __forceinline__ void walk(const Smem& sm, uint32_t win, int uc, int c, int ph_out,
                                     int pw_out, int grid_h, int grid_w, int gws, float count,
                                     T* o, int tid) {
  constexpr int kChunk = VEC * (int)sizeof(T);
  const int bins = ph_out * pw_out;
  for (int item = tid; item < bins * PARTS; item += kThreads) {
    const int bin = item / PARTS, part = item - bin * PARTS;
    const int k0 = part * NCH + (NCH == 2 ? (bin & 1) : 0);   // the lane's chunks
    const int k1 = part * NCH + (NCH == 2 ? 1 - (bin & 1) : 0);
    if (min(k0, k1) * VEC >= uc) continue;
    const int ph = bin / pw_out, pw = bin - ph * pw_out;
    const uint32_t b0 = win + k0 * kChunk, b1 = win + k1 * kChunk;
    float acc0[VEC], acc1[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc0[i] = acc1[i] = 0.f;
    for (int iy = 0; iy < grid_h; ++iy) {
      const Axis ya = sm.ys[ph * grid_h + iy];
#pragma unroll 1
      for (int ix = 0; ix < grid_w; ++ix) {
        const Axis xa = sm.xs[pw * gws + ix];
        float wt[4], f0[VEC], f1[VEC], f2[VEC], f3[VEC];
        weights(ya, xa, wt);
        Vec<T, VEC>::load_shared(b0 + ya.lo + xa.lo, f0);
        Vec<T, VEC>::load_shared(b0 + ya.lo + xa.hi, f1);
        Vec<T, VEC>::load_shared(b0 + ya.hi + xa.lo, f2);
        Vec<T, VEC>::load_shared(b0 + ya.hi + xa.hi, f3);
        add_sample<VEC>(acc0, f0, f1, f2, f3, wt);
        if constexpr (NCH == 2) {
          Vec<T, VEC>::load_shared(b1 + ya.lo + xa.lo, f0);
          Vec<T, VEC>::load_shared(b1 + ya.lo + xa.hi, f1);
          Vec<T, VEC>::load_shared(b1 + ya.hi + xa.lo, f2);
          Vec<T, VEC>::load_shared(b1 + ya.hi + xa.hi, f3);
          add_sample<VEC>(acc1, f0, f1, f2, f3, wt);
        }
      }
    }
    T* ob = o + ((int64_t)ph * pw_out + pw) * c;
    if (k0 * VEC < uc) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc0[i] = __fdiv_rn(acc0[i], count);
      Vec<T, VEC>::store(ob + k0 * VEC, acc0);
    }
    if (NCH == 2 && k1 * VEC < uc) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc1[i] = __fdiv_rn(acc1[i], count);
      Vec<T, VEC>::store(ob + k1 * VEC, acc1);
    }
  }
}

// VEC channels a copy and a load: kVecBytes where the channel count and the
// addresses allow, else 1. A block takes one ROI and up to kSlicesPerBlock
// of its channel slices.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) roi_align_fwd_kernel(
    Levels lv, int num_levels, int c, const float4* __restrict__ boxes,
    const int* __restrict__ level, const bool* __restrict__ valid, int ph_out, int pw_out,
    int sampling_ratio, int cap, int aligned, T* __restrict__ out) {
  constexpr int kSlice = kSliceBytes / (int)sizeof(T);   // channels a slice
  constexpr int kParts = kSlice / VEC;                   // threads a bin
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int slices = (c + kSlice - 1) / kSlice;
  const int groups = (slices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  const int roi = blockIdx.x / groups;
  const int s0 = (blockIdx.x - roi * groups) * kSlicesPerBlock;
  const int s1 = min(s0 + kSlicesPerBlock, slices);
  const int bins = ph_out * pw_out;
  T* o = out + (int64_t)roi * bins * c;
  // the ROI's three loads at once
  const bool ok = valid[roi];
  const int l = min(max(level[roi], 0), num_levels - 1);
  const float4 b = boxes[roi];

  if (!ok) {
    float z[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) z[i] = 0.f;
    for (int s = s0; s < s1; ++s) {
      const int c0 = s * kSlice, sc = min(kSlice, c - c0);
      for (int item = tid; item < bins * kParts; item += kThreads) {
        const int bin = item / kParts, part = item - bin * kParts;
        if (part * VEC < sc)
          Vec<T, VEC>::store(o + (int64_t)bin * c + c0 + part * VEC, z);
      }
    }
    return;
  }
  // pick the level with constant indices: indexing the parameter arrays with
  // l would copy them to local memory
  const T* f = static_cast<const T*>(lv.feat[0]);
  int h = lv.h[0], w = lv.w[0];
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i == l) {
      f = static_cast<const T*>(lv.feat[i]);
      h = lv.h[i];
      w = lv.w[i];
      scale = lv.scale[i];
    }
  }
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
  const float count = (float)max(grid_h * grid_w, 1);
  const int64_t ny = (int64_t)ph_out * grid_h, nx = (int64_t)pw_out * grid_w;

  // the branch: the ROI's own quantities, the same in every thread
  const int gws = grid_w | 1;   // the column table's row: odd, so two bins' entries share no bank
  bool staged = ny <= kTable && (int64_t)pw_out * gws <= kTable;
  int2 yr = make_int2(0, 0), xr = make_int2(0, 0);
  int wh = 0, ww = 0, unit = 0;
  Axis entry;   // this thread's table entry: a sample row (tid < ny) or column
  const bool is_y = staged && tid < ny;
  const int xj = tid - kTable, xp = xj / gws, xi = xj - xp * gws;
  const bool is_x = staged && tid >= kTable && xj < pw_out * gws && xi < grid_w;
  if (is_y) {
    const int p = tid / grid_h;
    entry = axis_cells(sample_pos(y1, bin_h, grid_h, p, tid - p * grid_h), h);
  } else if (is_x) {
    entry = axis_cells(sample_pos(x1, bin_w, grid_w, xp, xi), w);
  }
  if (staged) {
    // the window: the extreme cells of the entries, over the block
    int v[4] = {is_y ? entry.lo : INT_MAX, is_y ? -entry.hi : INT_MAX,
                is_x ? entry.lo : INT_MAX, is_x ? -entry.hi : INT_MAX};
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __reduce_min_sync(0xffffffffu, v[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm.bounds[tid >> 5][i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = sm.bounds[0][i];
      for (int wi = 1; wi < kThreads / 32; ++wi) v[i] = min(v[i], sm.bounds[wi][i]);
    }
    yr = make_int2(v[0], -v[1]);
    xr = make_int2(v[2], -v[3]);
    wh = yr.y - yr.x + 1;
    ww = xr.y - xr.x + 1;
    const int64_t cells = (int64_t)wh * ww;
    // 128-byte cells where the window fits them and the channels come in
    // 16-byte chunks, else 64-byte cells
    unit = (VEC * sizeof(T) == 16 && cells * 128 <= kBufferBytes) ? 128
           : (cells * 64 <= kBufferBytes ? 64 : 0);
    staged = unit > 0;
  }

  if (staged) {
    const int uc = unit / (int)sizeof(T);                 // channels a unit
    const int cg0 = s0 * kSlice, cg1 = min(s1 * kSlice, c);
    const int units = (cg1 - cg0 + uc - 1) / uc;
    // two buffers where two windows fit: unit u + 1 is copied in while unit
    // u is computed
    const bool two = 2 * wh * ww * unit <= kBufferBytes;
    const T* src = f + ((int64_t)yr.x * w + xr.x) * c;
    stage<T, VEC>(src + cg0, w, c, wh, ww, unit, min(uc, cg1 - cg0), sm.window, tid);
    cp_async_commit();
    // the tables, while the copies are in flight: offsets relative to the
    // window, in bytes
    if (is_y) {
      entry.lo = (entry.lo - yr.x) * ww * unit;
      entry.hi = (entry.hi - yr.x) * ww * unit;
      sm.ys[tid] = entry;
    } else if (is_x) {
      entry.lo = (entry.lo - xr.x) * unit;
      entry.hi = (entry.hi - xr.x) * unit;
      sm.xs[xj] = entry;
    }
    for (int u = 0; u < units; ++u) {
      const int cu = cg0 + u * uc, ucn = min(uc, cg1 - cu);
      unsigned char* buf = sm.window + (two && (u & 1) ? kBufferBytes / 2 : 0);
      if (two && u + 1 < units) {
        stage<T, VEC>(src + cu + uc, w, c, wh, ww, unit, min(uc, cg1 - cu - uc),
                      sm.window + ((u & 1) ? 0 : kBufferBytes / 2), tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t win = smem_addr(buf);
      if constexpr (VEC * sizeof(T) == 16) {
        if (unit == 128)
          walk<T, VEC, 2, 4>(sm, win, ucn, c, ph_out, pw_out, grid_h, grid_w, gws, count,
                               o + cu, tid);
        else
          walk<T, VEC, 1, 4>(sm, win, ucn, c, ph_out, pw_out, grid_h, grid_w, gws, count,
                               o + cu, tid);
      } else {
        walk<T, 1, 1, 64 / (int)sizeof(T)>(sm, win, ucn, c, ph_out, pw_out, grid_h, grid_w,
                                             gws, count, o + cu, tid);
      }
      __syncthreads();   // the buffer is copied into again
      if (!two && u + 1 < units) {
        stage<T, VEC>(src + cu + uc, w, c, wh, ww, unit, min(uc, cg1 - cu - uc),
                      sm.window, tid);
        cp_async_commit();
      }
    }
    return;
  }

  // direct branch: the corners from the map, each sample row and column
  // computed where it is used
  for (int s = s0; s < s1; ++s) {
    const int c0 = s * kSlice, sc = min(kSlice, c - c0);
    for (int item = tid; item < bins * kParts; item += kThreads) {
      const int bin = item / kParts, part = item - bin * kParts;
      if (part * VEC >= sc) continue;
      const int ph = bin / pw_out, pw = bin - ph * pw_out;
      const T* fc = f + c0 + part * VEC;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for (int iy = 0; iy < grid_h; ++iy) {
        const Axis ya = axis_cells(sample_pos(y1, bin_h, grid_h, ph, iy), h);
        const T* rlo = fc + (int64_t)ya.lo * w * c;
        const T* rhi = fc + (int64_t)ya.hi * w * c;
        for (int ix = 0; ix < grid_w; ++ix) {
          const Axis xa = axis_cells(sample_pos(x1, bin_w, grid_w, pw, ix), w);
          float wt[4], v[4][VEC];
          weights(ya, xa, wt);
          Vec<T, VEC>::load(rlo + (int64_t)xa.lo * c, v[0]);
          Vec<T, VEC>::load(rlo + (int64_t)xa.hi * c, v[1]);
          Vec<T, VEC>::load(rhi + (int64_t)xa.lo * c, v[2]);
          Vec<T, VEC>::load(rhi + (int64_t)xa.hi * c, v[3]);
          add_sample<VEC>(acc, v[0], v[1], v[2], v[3], wt);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fdiv_rn(acc[i], count);
      Vec<T, VEC>::store(o + (int64_t)bin * c + c0 + part * VEC, acc);
    }
  }
}

template <typename T, int VEC>
int launch_one(const Levels& lv, int num_levels, int c, const float4* boxes, const int* level,
               const bool* valid, int p, int ph, int pw, int sampling_ratio, int cap,
               int aligned, T* out, cudaStream_t st) {
  constexpr int kSlice = kSliceBytes / (int)sizeof(T);
  auto kern = roi_align_fwd_kernel<T, VEC>;
  static bool configured = false;   // once a process for each instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int64_t slices = (c + kSlice - 1) / kSlice;
  const int64_t blocks = (int64_t)p * ((slices + kSlicesPerBlock - 1) / kSlicesPerBlock);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, sizeof(Smem), st>>>(
      lv, num_levels, c, boxes, level, valid, ph, pw, sampling_ratio, cap, aligned, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Levels& lv, int num_levels, int c, bool wide, const void* boxes,
           const void* level, const void* valid, int p, int ph, int pw, int sampling_ratio,
           int cap, int aligned, void* out, cudaStream_t st) {
  auto b = static_cast<const float4*>(boxes);
  auto lvl = static_cast<const int*>(level);
  auto val = static_cast<const bool*>(valid);
  auto o = static_cast<T*>(out);
  if (wide)
    return launch_one<T, kVecBytes / sizeof(T)>(
        lv, num_levels, c, b, lvl, val, p, ph, pw, sampling_ratio, cap, aligned, o, st);
  return launch_one<T, 1>(lv, num_levels, c, b, lvl, val, p, ph, pw, sampling_ratio, cap,
                          aligned, o, st);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16. feats[num_levels]: (hs[l], ws[l], c)
// channels-last maps, contiguous; scales[l] their spatial scales. boxes (p, 4)
// f32, level (p,) int32 in [0, num_levels), valid (p,) bool, out (p, ph, pw, c)
// in the maps' dtype, all contiguous. sampling_ratio > 0 fixes the grid, else
// it is ceil(bin) capped at cap. wide != 0: every map and out 16-byte aligned
// and c a multiple of 16 bytes' worth of elements. Returns cudaGetLastError().
extern "C" int sos_roi_align_fwd(int dtype, int num_levels, const int64_t* feats, const int* hs,
                                 const int* ws, const float* scales, int c, int wide,
                                 const void* boxes, const void* level, const void* valid, int p,
                                 int ph, int pw, int sampling_ratio, int cap, int aligned,
                                 void* out, void* stream) {
  if (p == 0) return 0;
  if (num_levels < 1 || num_levels > kMaxLevels || c < 1 || ph < 1 || pw < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < num_levels ? l : 0;
    lv.feat[l] = reinterpret_cast<const void*>(feats[k]);
    lv.h[l] = hs[k];
    lv.w[l] = ws[k];
    lv.scale[l] = scales[k];
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(lv, num_levels, c, wide != 0, boxes, level, valid, p, ph, pw,
                         sampling_ratio, cap, aligned, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(lv, num_levels, c, wide != 0, boxes, level, valid, p, ph, pw,
                                 sampling_ratio, cap, aligned, out, st);
  return (int)cudaErrorInvalidValue;
}

// The build's constants, for the launch plan's check: threads, slice bytes,
// buffer bytes, table entries, blocks an SM, shared memory bytes a block,
// slices a block, vector bytes.
extern "C" void sos_roi_align_fwd_config(int* out) {
  out[0] = kThreads;
  out[1] = kSliceBytes;
  out[2] = kBufferBytes;
  out[3] = kTable;
  out[4] = kBlocksPerSm;
  out[5] = (int)sizeof(Smem);
  out[6] = kSlicesPerBlock;
  out[7] = kVecBytes;
}
