// ROIPool backward for Hopper (sm_90a): adds the row-scaled cotangent of the
// pooled bins onto the feature map at the forward's argmax.
//
// Replaces the backward of the TPU kernel
// sos_wsod_tpu/ops/pallas/roi_pool_fused.py:303 (_bwd, the VJP of
// roi_pool_fused registered at :320), which re-runs the Pallas forward for
// the argmax and then scatter-adds in f32 with XLA. Here the forward kernel's
// argmax is saved by the autograd Function (sos_wsod_torch/ops/roi_pool.py)
// and passed in with the bin windows it was computed from.
//
// Semantics (as in ops/roi_pool.py:roi_pool_backward_reference):
//   out[pos[p,ph,pw,c], c] = sum over bins, in ascending (p, ph, pw) order,
//                            of float(g[p,ph,pw,c]) * rs[p]   for pos >= 0
// into an f32 (H, W, C) map, every element of which the kernel writes. rs is
// the row scale already rounded to the feature type and widened to f32, or
// null for no scale. Each product is rounded once (__fmul_rn) and each add
// once (__fadd_rn, never contracted into an FMA), and every cell's terms are
// added in bin order starting from +0, which is the order of the plain
// version's index_add_ on the CPU: the result is bit-identical to it and the
// same from run to run.
//
// Precondition: pos is the forward's argmax for these windows, so each entry
// of a bin lies in that bin's window [hs, he) x [ws, we) or is -1. The kernel
// looks for a bin's entries only in the tiles its window meets.
//
// Bound: the function reads g (bf16 or f32) and pos (int32) once and writes
// the f32 map once: at P = 4096, 7 x 7 bins, 512 channels and bf16, 616.6 MB
// + 21.2 MB (87 x 119) or 63.5 MB (152 x 204), 0.190 / 0.203 ms at the
// H100's 3.35 TB/s. This design reads a bin's g and pos rows once for every
// tile its window meets: 1.85 / 2.69 tiles a live bin on the main path's
// inputs at 8 x 8 tiles, 1.12 / 1.62 GB of reads. What bounds it: those
// reads, then the spread of work between tiles (the busiest 8 x 8 tile at
// 87 x 119 holds 2.5 times the average's bins, and one warp adds them all
// in order), then the instructions of the adds.
//
// Design:
//   - A block owns kTileH x kTileW cells (a tile) times kSlice channels (a
//     slice) of the output, keeps them as f32 in shared memory and writes
//     them out once at its end; the slices of a tile are neighbouring blocks,
//     so they run side by side (the busiest tiles are not left to a last
//     wave). No atomics, no zeroed
//     output. Ragged tiles at the map's edge and a ragged last slice are
//     masked. Shared memory is a constant of the build (sizeof(Smem)), never
//     a function of H, W or P, so every shape runs this one path.
//   - Each (cell, channel) has exactly one owner thread: a warp owns 32
//     channels of the whole tile, a lane one channel. No two threads add to
//     one address, and a warp's lanes hit 32 different banks.
//   - One more warp a block fills two queues in shared memory, in turns, with
//     the bins whose windows meet the tile, in ascending (p, ph, pw) order
//     (see fill()); named barriers hand a queue to the adding warps and back,
//     so the search for the next bins overlaps the adds.
//   - An adding warp walks each queue in order. A lane loads its channel's
//     g and pos of kAdds bins into registers, two groups of kAdds ahead of
//     its adds, keeps the entries whose pos falls in the tile (pos split into
//     (y, x) by a multiply-shift division by W), reads the cells they touch,
//     adds in queue order, carrying a sum in registers from one entry to a
//     later one of the same cell, and stores.
//   - kTileH, kTileW, kWarps and kAdds were chosen by a sweep
//     (sos_wsod_torch/tools/bench_roi_pool.py --sweep, PERF.md section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;       // output tile rows
constexpr int kTileW = 8;       // output tile columns
constexpr int kWarps = 4;       // adding warps a block, each owning 32 channels of the whole tile
constexpr int kAdds = 8;        // bins whose entries a lane holds before it adds them
constexpr int kQueue = 512;     // bins a queue holds
constexpr int kRois = 8;        // ROIs a lane of the filling warp tests at a time
constexpr int kSlice = kWarps * 32;        // channels of a block
constexpr int kThreads = kSlice + 32;      // the adding warps and the filling warp
constexpr int kCells = kTileH * kTileW;

struct Smem {
  float acc[kCells * kSlice];   // [cell][channel]
  int32_t bin[2][kQueue];       // two queues of flat (p, ph, pw), filled and added in turns
  float rs[2][kQueue];          // each bin's row scale
  int32_t qlen[2];              // bins in each queue
  int32_t last[2];              // whether the queue is the walk's last
  int32_t hits[32 * kRois];     // the filling warp's ROIs that meet the tile, in order
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

// The barriers of queue q (0 or 1).
__device__ __forceinline__ void wait_full(int q) { q ? bar_sync<kFull + 1>() : bar_sync<kFull>(); }
__device__ __forceinline__ void wait_free(int q) { q ? bar_sync<kFree + 1>() : bar_sync<kFree>(); }
__device__ __forceinline__ void mark_full(int q) {
  q ? bar_arrive<kFull + 1>() : bar_arrive<kFull>();
}
__device__ __forceinline__ void mark_free(int q) {
  q ? bar_arrive<kFree + 1>() : bar_arrive<kFree>();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// n / d for 0 <= n < 2^31 by a multiply and a shift (magic m and shift s
// from the host, as PyTorch's IntDivider computes them).
__device__ __forceinline__ int div_by(int n, uint32_t m, uint32_t s) {
  return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
}

// Inclusive prefix sum of v over the warp.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// The run [first, first + count) of bins along one axis whose non-empty
// window [s, e) meets [lo, hi). Bounds are monotone along the axis, so the
// bins that meet it are contiguous. Loads 8 bounds at a time, all issued
// before they are compared.
__device__ __forceinline__ void span(const int32_t* s, const int32_t* e, int n, int lo, int hi,
                                     int& first, int& count) {
  first = -1;
  int last = -1;
  for (int i0 = 0; i0 < n; i0 += 8) {
    int a[8], b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] = i0 + k < n ? s[i0 + k] : 0;
      b[k] = i0 + k < n ? e[i0 + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (b[k] > a[k] && b[k] > lo && a[k] < hi) {
        if (first < 0) first = i0 + k;
        last = i0 + k;
      }
    }
  }
  count = first < 0 ? 0 : last - first + 1;
}

// A lane's entries of kAdds queued bins: pos (-1 where none) and g.
template <typename T>
struct Group {
  int32_t q[kAdds];
  T g[kAdds];
};

// Loads the lane's entries of bins i0 ... i0 + kAdds - 1 of the queue.
template <typename T>
__device__ __forceinline__ void fetch(Group<T>& r, const int32_t* bins, int i0, int qlen,
                                      const T* g, const int32_t* pos, int C, int ch, bool live) {
#pragma unroll
  for (int e = 0; e < kAdds; ++e) {
    r.q[e] = -1;
    if (live && i0 + e < qlen) {
      const int at = bins[i0 + e] * C + ch;   // the wrapper keeps g's size below 2^31
      r.q[e] = __ldg(pos + at);
      r.g[e] = __ldg(g + at);
    }
  }
}

// Adds a group's entries that fall in the tile, in queue order. The cells
// they touch are read first, all at once; an entry whose cell an earlier
// one of the group touched adds to that entry's sum; the last store of a
// cell holds its sum.
template <typename T>
__device__ __forceinline__ void add_group(Smem& s, const float* rs, const Group<T>& r, int i0,
                                          bool scaled, int ty0, int tx0, int W,
                                          uint32_t w_magic, uint32_t w_shift, int lane_ch) {
  int cell[kAdds];
  float v[kAdds], sum[kAdds];
#pragma unroll
  for (int e = 0; e < kAdds; ++e) {
    const int q = r.q[e];
    const int y = div_by(max(q, 0), w_magic, w_shift);
    const int ly = y - ty0, lx = q - y * W - tx0;
    const bool in = q >= 0 && (unsigned)ly < (unsigned)kTileH && (unsigned)lx < (unsigned)kTileW;
    cell[e] = in ? (ly * kTileW + lx) * kSlice + lane_ch : -1;
    v[e] = to_f32(r.g[e]);
    if (scaled && in) v[e] = __fmul_rn(v[e], rs[i0 + e]);
    sum[e] = in ? s.acc[cell[e]] : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < kAdds; ++e) {
#pragma unroll
    for (int d = 0; d < e; ++d) {
      if (cell[d] == cell[e]) sum[e] = sum[d];
    }
    sum[e] = __fadd_rn(sum[e], v[e]);
  }
#pragma unroll
  for (int e = 0; e < kAdds; ++e) {
    if (cell[e] >= 0) s.acc[cell[e]] = sum[e];
  }
}

// The filling warp: queues, in turns in the two queues, the bins whose
// windows meet the tile, in ascending (p, ph, pw) order. Its lanes test the
// outer extents of 32 kRois ROIs at a time (bin bounds are monotone in ph
// and pw), kRois each with all loads issued together, and list the ROIs
// that meet the tile in order; then each lane takes one listed ROI, finds
// the rectangle of (ph, pw) whose bins meet the tile, and a prefix sum over
// the lanes places the bins. A full queue is handed over and the same ROIs'
// remaining bins go to the other one.
__device__ __forceinline__ void fill(Smem& s, const float* rs, const int32_t* hs,
                                     const int32_t* he, const int32_t* ws, const int32_t* we,
                                     const uint8_t* valid, int P, int PH, int PW, int ty0,
                                     int ty1, int tx0, int tx1) {
  const int lane = threadIdx.x % 32;
  int r = 0, qlen = 0;   // the round (queue r & 1) and its bins so far
  auto hand_over = [&](bool last) {
    if (lane == 0) {
      s.qlen[r & 1] = qlen;
      s.last[r & 1] = last;
    }
    __syncwarp();
    __threadfence_block();
    mark_full(r & 1);
    ++r;
    qlen = 0;
    if (!last && r >= 2) wait_free(r & 1);   // the adding warps are done with round r - 2
  };
  for (int p0 = 0; p0 < P; p0 += 32 * kRois) {
    uint32_t mask = 0;
#pragma unroll
    for (int j0 = 0; j0 < kRois; j0 += 4) {   // 4 ROIs' loads at a time: fewer registers
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) {
        const int p = p0 + kRois * lane + j;
        if (p < P) {
          const int64_t rh = (int64_t)p * PH, rw = (int64_t)p * PW;
          const bool ok = valid[p] != 0;
          const int y0 = hs[rh], y1 = he[rh + PH - 1], x0 = ws[rw], x1 = we[rw + PW - 1];
          if (ok && y0 < ty1 && y1 > ty0 && x0 < tx1 && x1 > tx0) mask |= 1u << j;
        }
      }
    }
    const int cnt = __popc(mask), incl = warp_scan(cnt);
    const int hits = __shfl_sync(0xffffffffu, incl, 31);
    for (int k = incl - cnt; mask; mask &= mask - 1) s.hits[k++] = p0 + kRois * lane + __ffs(mask) - 1;
    __syncwarp();
    for (int t0 = 0; t0 < hits; t0 += 32) {
      int p = -1, a = 0, nh = 0, b = 0, nw = 0;
      if (t0 + lane < hits) {
        p = s.hits[t0 + lane];
        span(hs + (int64_t)p * PH, he + (int64_t)p * PH, PH, ty0, ty1, a, nh);
        span(ws + (int64_t)p * PW, we + (int64_t)p * PW, PW, tx0, tx1, b, nw);
      }
      const float scale = p >= 0 && rs ? rs[p] : 1.0f;
      const int n = nh * nw, incl_n = warp_scan(n);
      const int total = __shfl_sync(0xffffffffu, incl_n, 31), off = incl_n - n;
      for (int done = 0; done < total;) {   // bins [done, done + take) of this group
        const int take = min(kQueue - qlen, total - done);
        const int lo = max(done - off, 0), hi = min(n, done + take - off);
        if (lo < hi) {
          int ph = a + lo / nw, pw = b + lo % nw;
          for (int k = lo; k < hi; ++k) {
            s.bin[r & 1][qlen + off + k - done] = (p * PH + ph) * PW + pw;
            s.rs[r & 1][qlen + off + k - done] = scale;
            if (++pw == b + nw) {
              pw = b;
              ++ph;
            }
          }
        }
        qlen += take;
        done += take;
        if (qlen == kQueue) hand_over(false);
      }
      __syncwarp();   // s.hits is rewritten by the next 32 kRois ROIs
    }
  }
  hand_over(true);
  // wait for the adds of the last two rounds, so that every arrival at a
  // kFree barrier has its wait
  for (int rr = max(r - 2, 0); rr < r; ++rr) wait_free(rr & 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_bwd_kernel(const T* __restrict__ g, const int32_t* __restrict__ pos,
                    const float* __restrict__ rs, const int32_t* __restrict__ hs,
                    const int32_t* __restrict__ he, const int32_t* __restrict__ ws,
                    const int32_t* __restrict__ we, const uint8_t* __restrict__ valid, int P,
                    int PH, int PW, int C, int H, int W, uint32_t w_magic, uint32_t w_shift,
                    int tiles_x, int slices, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  // block = tile * slices + slice: the slices of a tile run side by side
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int ty0 = tile / tiles_x * kTileH, tx0 = tile % tiles_x * kTileW;
  const int ty1 = min(ty0 + kTileH, H), tx1 = min(tx0 + kTileW, W);
  if (threadIdx.x >= kSlice) {
    fill(s, rs, hs, he, ws, we, valid, P, PH, PW, ty0, ty1, tx0, tx1);
    return;
  }
  const int c = threadIdx.x;                       // the lane's channel within the slice
  const int ch = slice * kSlice + c;               // and within the map
  const bool live = ch < C;

  // the owner zeroes its cells
#pragma unroll
  for (int k = 0; k < kCells; ++k) s.acc[k * kSlice + c] = 0.0f;

  // each warp walks the queues in order, its loads two groups ahead of its
  // adds: three groups of registers take turns, so none is copied
  for (int r = 0;; ++r) {
    const int q = r & 1;
    wait_full(q);
    const int qlen = s.qlen[q];
    const bool last = s.last[q] != 0;
    const int32_t* bins = s.bin[q];
    const float* scales = s.rs[q];
    Group<T> ga, gb, gc;
    fetch(ga, bins, 0, qlen, g, pos, C, ch, live);
    fetch(gb, bins, kAdds, qlen, g, pos, C, ch, live);
    fetch(gc, bins, 2 * kAdds, qlen, g, pos, C, ch, live);
    for (int i = 0; i < qlen; i += 3 * kAdds) {
      add_group(s, scales, ga, i, rs != nullptr, ty0, tx0, W, w_magic, w_shift, c);
      fetch(ga, bins, i + 3 * kAdds, qlen, g, pos, C, ch, live);
      add_group(s, scales, gb, i + kAdds, rs != nullptr, ty0, tx0, W, w_magic, w_shift, c);
      fetch(gb, bins, i + 4 * kAdds, qlen, g, pos, C, ch, live);
      add_group(s, scales, gc, i + 2 * kAdds, rs != nullptr, ty0, tx0, W, w_magic, w_shift, c);
      fetch(gc, bins, i + 5 * kAdds, qlen, g, pos, C, ch, live);
    }
    __syncwarp();
    __threadfence_block();
    mark_free(q);
    if (last) break;
  }

  // the owner writes its cells
  if (live) {
    for (int y = ty0; y < ty1; ++y) {
      for (int x = tx0; x < tx1; ++x) {
        out[((int64_t)y * W + x) * C + ch] = s.acc[((y - ty0) * kTileW + x - tx0) * kSlice + c];
      }
    }
  }
}

template <typename T>
int launch(const void* g, const int32_t* pos, const float* rs, const int32_t* hs,
           const int32_t* he, const int32_t* ws, const int32_t* we, const uint8_t* valid,
           int P, int PH, int PW, int C, int H, int W, float* out, cudaStream_t stream) {
  // the multiply-shift divider by W (PyTorch's IntDivider)
  uint32_t shift = 0;
  while (shift < 32 && (1ull << shift) < (uint64_t)W) ++shift;
  const uint64_t magic = ((1ull << 32) * ((1ull << shift) - (uint64_t)W)) / (uint64_t)W + 1;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const int slices = (C + kSlice - 1) / kSlice;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(roi_pool_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  roi_pool_bwd_kernel<T><<<tiles_x * tiles_y * slices, kThreads, smem, stream>>>(
      static_cast<const T*>(g), pos, rs, hs, he, ws, we, valid, P, PH, PW, C, H, W,
      (uint32_t)magic, shift, tiles_x, slices, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The build's constants: tile rows, tile columns, channels a block, threads
// a block, dynamic shared memory bytes a block.
extern "C" void sos_roi_pool_bwd_config(int* out) {
  out[0] = kTileH;
  out[1] = kTileW;
  out[2] = kSlice;
  out[3] = kThreads;
  out[4] = (int)sizeof(Smem);
}

// dtype of g: 0 = float32, 1 = bfloat16. g and pos are (P, PH, PW, C)
// contiguous; rs is (P,) f32 or null; hs/he (P, PH) and ws/we (P, PW) int32
// are the windows the forward computed pos from, valid (P,) bool; out is an
// (H, W, C) f32 buffer that the kernel writes whole. Returns
// cudaGetLastError() after the launch (0 on success); P, C, H or W == 0
// launches nothing.
extern "C" int sos_roi_pool_bwd(int dtype, const void* g, const void* pos, const void* rs,
                                const void* hs, const void* he, const void* ws, const void* we,
                                const void* valid, int P, int PH, int PW, int C, int H, int W,
                                void* out, void* stream) {
  if (P == 0 || C == 0 || H == 0 || W == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto args = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(g, i32(pos), static_cast<const float*>(rs), i32(hs), i32(he), i32(ws),
                     i32(we), static_cast<const uint8_t*>(valid), P, PH, PW, C, H, W,
                     static_cast<float*>(out), st);
  };
  if (dtype == 0) return args(float{});
  if (dtype == 1) return args(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
