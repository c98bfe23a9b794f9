// ROIPool forward for Hopper (sm_90a): channels-last max pool of one
// (H, W, C) feature map into (P, PH, PW, C) bins, with first-hit argmax.
//
// Replaces the TPU kernel sos_wsod_tpu/ops/pallas/roi_pool_fused.py
// (_roi_pool_fused_fwd_impl, pallas_call at :240, body _make_kernel). The
// Pallas kernel encodes (value, position) into int32 keys and keeps a
// vertical doubling table in VMEM; none of that is needed here. This kernel
// reads the feature map as it is and scans each bin's window directly.
//
// Semantics (torchvision RoIPool, as in sos_wsod_torch/ops/roi_pool.py):
//   - bin windows [hs, he) x [ws, we) come in precomputed as int32 (P, PH)
//     and (P, PW) from ops/roi_pool.py:bin_windows, so the window math
//     exists once, in PyTorch;
//   - the window is scanned h-major then w with a strict '>' comparison,
//     starting from its first cell, so ties go to the first hit: the
//     smallest flat y*W+x;
//   - out = T(float(max) * float(T(row_scale[p]))): the scale is cast to the
//     feature type first and the product, exact in f32 for bf16 operands,
//     is rounded once, which is bit-identical to a bf16 x bf16 multiply;
//   - empty windows and invalid slots give 0 and pos -1; pos may be null.
//
// Bound: the function reads the map once and writes out and pos once. At
// the production shape (feat 87 x 119 x 512 bf16, P = 4096, 7 x 7 bins)
// that is 10.6 MB + 205.5 MB + 411.0 MB, 0.187 ms at the H100's 3.35 TB/s
// of HBM (0.065 ms without pos). The map stays in the 50 MB L2, but every
// bin reads its own window from there: the windows hold 3.03 M cells, 3.10
// GB at 512 bf16 channels (7.5 GB at the 152 x 204 top training map). So
// the kernel is bound by L2 reads of window cells and the instructions that
// compare them, then by the HBM writes of out and pos.
//
// Design:
//   - One warp per bin and 32 16-byte channel vectors: a lane owns 8 bf16 (4
//     f32) channels, so each load of a warp reads 512 contiguous bytes of
//     one cell (the first design's 2-byte loads took 8x the instructions).
//     A block holds 8 warps, i.e. 8 consecutive bins of one channel range;
//     grid.y walks the channel ranges (2 for 512 bf16 channels). P = 4096
//     gives 25,088 x 2 blocks of 256 threads, at most 64 registers a thread
//     (4 blocks an SM).
//   - The lane walks its window as one flat h-major index and loads kUnroll
//     cells (4 bf16, 2 f32; independent 16-byte loads) before it compares
//     them; past the end it re-reads a cell and does not compare it. The
//     compares run in scan order, so the result is the sequential first-hit
//     scan's, with no combine step.
//   - bf16 compares two channels an instruction (__hgt2_mask) and keeps the
//     maximum and the argmax as bit selects of 32-bit words: the argmax as
//     16-bit offsets from the first cell of the current chunk, two a word,
//     turned into flat positions once per chunk. A chunk is the whole
//     window unless its cells span more than 0xffff flat positions (only
//     on maps far wider than the model's): then whole rows, or pieces of one
//     row, a chunk. f32 compares one channel at a time and keeps positions
//     as they are.
//   - out is stored as one 16-byte vector a lane, pos as 32 bytes (two
//     16-byte stores; one for f32), both streaming (st.global.cs): the main
//     path reads neither back before they have left L2, and evict-first
//     stores leave L2 to the map.
//   - No shared memory, so nothing is sized by H x W and every shape the
//     wrapper takes runs this one path. A channel count that is not a
//     multiple of the vector width, or a pointer that is not 16-byte
//     aligned, makes the same loop load and store its 16 bytes one channel
//     at a time (the masked tail; C = 1, 3 in the tests).
//   - The argmax is a template flag: without pos the lanes track no
//     positions.
//   - 4 bf16 and 2 f32 cells in flight a lane and 4 blocks an SM (kMinBlocks)
//     were chosen by a sweep of 1 to 8 cells and 3 to 5 blocks.
// Times, beside the bound and the first design's, and the sweep: PERF.md
// section 6, measured by sos_wsod_torch/tools/bench_roi_pool.py.
// Not done: reading fewer cells than the windows hold (a vertical max
// level, or tiles shared by overlapping ROIs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // bins per block, one warp each
constexpr int kMinBlocks = 4;     // blocks an SM must hold: at most 64 registers a thread
constexpr int kSpan = 0xffff;     // a chunk's flat positions lie within this

__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

__device__ __forceinline__ uint32_t& word(uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// A lane's 16 bytes of channels, kept as raw bits: N elements of kBits.
// fold() takes one more cell of the scan into the running maximum `best`
// (raw bits too) and, with kPos, its position into the Track: an element is
// replaced only where the new value is strictly greater. The scan runs in
// chunks (see the kernel); resolve() turns a chunk's Track into flat
// positions in `arg` where the chunk replaced the maximum.
template <typename T> struct Lane;

template <> struct Lane<float> {
  static constexpr int N = 4, kBits = 32, kUnroll = 2;  // cells loaded before they are compared
  struct Track {
    int32_t cell[N];  // flat position, -1 where the chunk replaced nothing
  };
  static __device__ __forceinline__ float get(const uint4& r, int j) {
    return __uint_as_float(word(r, j));
  }
  static __device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ Track track() {
    Track t;
#pragma unroll
    for (int j = 0; j < N; ++j) t.cell[j] = -1;
    return t;
  }
  template <bool kPos>
  static __device__ __forceinline__ void fold(uint4& best, Track& t, const uint4& v, int cell,
                                              uint32_t /*offset2*/) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (get(v, k) > get(best, k)) {
        word(best, k) = word(v, k);
        if (kPos) t.cell[k] = cell;
      }
    }
  }
  static __device__ __forceinline__ void resolve(const Track& t, int32_t (&arg)[N],
                                                 int /*first*/) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (t.cell[j] >= 0) arg[j] = t.cell[j];
    }
  }
};

// bf16 compares two channels at once: __hgt2_mask gives 0xffff in each half
// where v > best (an exact compare, as of the values widened to f32), and
// the new best is a bit select of the two words. Positions are kept the same
// way, as 16-bit offsets from the chunk's first cell, two to a word
// (`offset2` holds the cell's offset in both halves), so one more bit select
// tracks both channels' argmax.
template <> struct Lane<__nv_bfloat16> {
  static constexpr int N = 8, kBits = 16, kUnroll = 4;
  static __device__ __forceinline__ float get(const uint4& r, int j) {
    const uint32_t w = word(r, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t w) {
    return *reinterpret_cast<const __nv_bfloat162*>(&w);
  }
  struct Track {
    uint4 off;  // 16-bit offsets from the chunk's first cell, kSpan where none
  };
  static __device__ __forceinline__ Track track() {
    return Track{make_uint4(~0u, ~0u, ~0u, ~0u)};
  }
  template <bool kPos>
  static __device__ __forceinline__ void fold(uint4& best, Track& t, const uint4& v,
                                              int /*cell*/, uint32_t offset2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = __hgt2_mask(pair(word(v, k)), pair(word(best, k)));
      word(best, k) = (word(v, k) & m) | (word(best, k) & ~m);
      if (kPos) word(t.off, k) = (offset2 & m) | (word(t.off, k) & ~m);
    }
  }
  static __device__ __forceinline__ void resolve(const Track& t, int32_t (&arg)[N], int first) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int o = (word(t.off, j >> 1) >> (j & 1 ? 16 : 0)) & 0xffff;
      if (o != kSpan) arg[j] = first + o;
    }
  }
};

// 16 bytes of channels at src; n < N channels (or a misaligned row) one at
// a time, the rest zero.
template <typename T>
__device__ __forceinline__ uint4 load_lane(const T* src, int n, bool vec) {
  using L = Lane<T>;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint4 r = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < L::N; ++j) {
    if (j < n) {
      const uint32_t e = L::kBits == 16
          ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(src) + j)
          : __ldg(reinterpret_cast<const unsigned int*>(src) + j);
      word(r, j * L::kBits / 32) |= e << (j * L::kBits % 32);
    }
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store_out(T* dst, const float (&v)[Lane<T>::N], int n,
                                          bool vec) {
  using L = Lane<T>;
  if (vec) {
    uint4 r = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < L::N; ++j) {
      word(r, j * L::kBits / 32) |= L::bits(v[j]) << (j * L::kBits % 32);
    }
    __stcs(reinterpret_cast<uint4*>(dst), r);
    return;
  }
#pragma unroll
  for (int j = 0; j < L::N; ++j) {
    if (j < n) {
      if (L::kBits == 16) {
        __stcs(reinterpret_cast<unsigned short*>(dst) + j, (unsigned short)L::bits(v[j]));
      } else {
        __stcs(reinterpret_cast<unsigned int*>(dst) + j, L::bits(v[j]));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void store_pos(int32_t* dst, const int32_t (&a)[N], int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      __stcs(reinterpret_cast<int4*>(dst) + q,
             make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) __stcs(dst + j, a[j]);
  }
}

template <typename T, bool kPos>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
roi_pool_fwd_kernel(const T* __restrict__ feat, int H, int W, int C, bool vec,
                    const int32_t* __restrict__ hs, const int32_t* __restrict__ he,
                    const int32_t* __restrict__ ws, const int32_t* __restrict__ we,
                    const uint8_t* __restrict__ valid, const float* __restrict__ row_scale,
                    int bins, int PH, int PW, T* __restrict__ out, int32_t* __restrict__ pos) {
  using L = Lane<T>;
  constexpr int N = L::N, kUnroll = L::kUnroll;
  const int bin = blockIdx.x * kWarps + threadIdx.x / 32;   // flat (p, ph, pw)
  const int c0 = (blockIdx.y * 32 + threadIdx.x % 32) * N;  // the lane's first channel
  if (bin >= bins || c0 >= C) return;
  const int nc = min(N, C - c0);
  const int pw = bin % PW, ph = bin / PW % PH, p = bin / (PW * PH);
  const int h0 = hs[p * PH + ph], h1 = he[p * PH + ph];
  const int w0 = ws[p * PW + pw], w1 = we[p * PW + pw];

  float v_out[N];
  int32_t arg[N];
  if (valid[p] != 0 && h1 > h0 && w1 > w0) {
    const T* src = feat + c0;
    uint4 best = load_lane<T>(src + ((int64_t)h0 * W + w0) * C, nc, vec);
#pragma unroll
    for (int j = 0; j < N; ++j) arg[j] = h0 * W + w0;
    const int nh = h1 - h0, nw = w1 - w0, n = nh * nw;
    // The scan runs in chunks: runs of cells whose flat positions lie
    // within kSpan - 1 of the chunk's first cell, which a bf16 lane's 16-bit
    // offsets can hold. The whole window is one chunk unless it spans more
    // than kSpan flat positions: then a chunk is as many whole rows as fit,
    // or a piece of one row where a row alone is wider.
    const int rows = (nh - 1) * W + nw <= kSpan ? nh : nw <= kSpan ? (kSpan - nw) / W + 1 : 0;
    int y = h0, x = w0 + 1;  // the next cell to load
    if (x == w1) {
      x = w0;
      ++y;
    }
    for (int base = 0, end; base < n; base = end) {
      const int size = rows ? rows * nw : min(kSpan, nw - base % nw);
      end = n - base > size ? base + size : n;
      const int first = base == 0 ? h0 * W + w0 : (h0 + base / nw) * W + w0 + base % nw;
      typename L::Track t = L::track();
      for (int i = max(base, 1); i < end; i += kUnroll) {
        uint4 r[kUnroll];
        int f[kUnroll];
        bool live[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {  // the loads; past the chunk's end, not advanced
          live[k] = i + k < end;
          f[k] = min(y, h1 - 1) * W + x;
          r[k] = load_lane<T>(src + (int64_t)f[k] * C, nc, vec);
          if (live[k] && ++x == w1) {
            x = w0;
            ++y;
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {  // the compares, in scan order
          if (live[k]) {
            L::template fold<kPos>(best, t, r[k], f[k], (uint32_t)(f[k] - first) * 0x10001u);
          }
        }
      }
      if (kPos) L::resolve(t, arg, first);
    }
    const float s = row_scale ? L::round(row_scale[p]) : 1.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) v_out[j] = L::get(best, j) * s;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v_out[j] = 0.0f;
      arg[j] = -1;
    }
  }
  const int64_t o = (int64_t)bin * C + c0;
  store_out<T>(out + o, v_out, nc, vec);
  if (kPos) store_pos<N>(pos + o, arg, nc, vec);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
void launch(const void* feat, int H, int W, int C, const int32_t* hs, const int32_t* he,
            const int32_t* ws, const int32_t* we, const uint8_t* valid, const float* row_scale,
            int P, int PH, int PW, void* out, int32_t* pos, cudaStream_t stream) {
  constexpr int N = Lane<T>::N;
  const int bins = P * PH * PW;
  const bool vec = C % N == 0 && aligned16(feat) && aligned16(out) && (!pos || aligned16(pos));
  const dim3 grid((bins + kWarps - 1) / kWarps, ((C + N - 1) / N + 31) / 32);
  auto f = static_cast<const T*>(feat);
  auto o = static_cast<T*>(out);
  if (pos) {
    roi_pool_fwd_kernel<T, true><<<grid, kWarps * 32, 0, stream>>>(
        f, H, W, C, vec, hs, he, ws, we, valid, row_scale, bins, PH, PW, o, pos);
  } else {
    roi_pool_fwd_kernel<T, false><<<grid, kWarps * 32, 0, stream>>>(
        f, H, W, C, vec, hs, he, ws, we, valid, row_scale, bins, PH, PW, o, nullptr);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); P == 0 or C == 0 launches nothing.
extern "C" int sos_roi_pool_fwd(int dtype, const void* feat, int H, int W, int C,
                                const void* hs, const void* he, const void* ws,
                                const void* we, const void* valid,
                                const void* row_scale, int P, int PH, int PW,
                                void* out, void* pos, void* stream) {
  if (P == 0 || C == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto v8 = static_cast<const uint8_t*>(valid);
  auto rs = static_cast<const float*>(row_scale);
  auto pos32 = static_cast<int32_t*>(pos);
  if (dtype == 0) {
    launch<float>(feat, H, W, C, i32(hs), i32(he), i32(ws), i32(we), v8, rs, P, PH, PW, out,
                  pos32, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(feat, H, W, C, i32(hs), i32(he), i32(ws), i32(we), v8, rs, P, PH,
                          PW, out, pos32, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
