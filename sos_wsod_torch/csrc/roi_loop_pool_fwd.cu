// ROILoopPool forward for Hopper (sm_90a): channels-last max pool of one
// (H, W, C) feature map over three regions of each ROI, into (3P, PH, PW, C)
// bins stacked [box; frame; context], with first-hit argmax.
//
// Replaces the XLA op sos_wsod_tpu/ops/roi_loop_pool.py:55 (roi_loop_pool),
// which answers each region as the max of up to four rectangles of a sparse
// max table. This kernel scans each bin's window directly, as the reference
// CUDA kernel of ROILoopPool does.
//
// Semantics (sos_wsod_torch/ops/roi_loop_pool.py):
//   - each of the 3P rows comes with its bin windows [hs, he) x [ws, we)
//     (int32 (3P, PH) and (3P, PW), from ops/roi_pool.py:bin_windows: the
//     box's for the box and frame rows, the outer box's for the context
//     rows) and an exclusion rectangle ex = (h1, h2, w1, w2) (int32 (3P, 4)):
//     a cell (y, x) with h1 < y < h2 and w1 < x < w2 is left out. The window
//     math exists once, in PyTorch;
//   - the maximum starts at 0 with argmax -1 (the reference kernel assumes
//     non-negative inputs); the kept cells are scanned h-major then w with a
//     strict '>', so the argmax is the first hit: the smallest flat y*W+x
//     among ties, and -1 where no kept cell is above 0;
//   - out = T(float(max) * float(T(row_scale[p]))) with p = row % P: the
//     scale cast to the feature type, the product rounded once (a bf16 x bf16
//     multiply); invalid ROIs give 0 and pos -1 in all three rows; pos may
//     be null.
//
// Bound: the function reads the map once and writes out and pos once. At
// the production shape (feat 87 x 119 x 512 bf16, P = 4096, 7 x 7 bins) that
// is 10.6 MB + 616.6 MB + 1,233.1 MB = 1,860.3 MB, 0.555 ms at the H100's
// 3.35 TB/s (627.2 MB, 0.187 ms without pos).
//
// Design (a first version, kernel A's layout):
//   - one warp a bin and 32 16-byte channel vectors: a lane owns 8 bf16 (4
//     f32) channels and each load of a warp reads 512 contiguous bytes of one
//     cell. A block holds 8 warps, 8 consecutive bins of one channel range;
//     grid.y walks the channel ranges;
//   - a bin's rows are walked in order; in a row that crosses the exclusion
//     rectangle the lane scans the run left of it and the run right of it,
//     so excluded cells are never loaded and the scan order is kept. The
//     test is warp-uniform (a warp holds one bin);
//   - the running maximum is kept in f32 (exact for bf16) and compared one
//     channel at a time;
//   - out and pos are stored as 16-byte vectors, streaming (st.global.cs).
//     A channel count that is not a multiple of the vector width, or a
//     pointer that is not 16-byte aligned, loads and stores one channel at a
//     time.
// Not done: kernel A's paired bf16 compares and 16-bit offsets, or a shared
// read of the cells that the box, frame and context rows of a ROI share.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // bins a block, one warp each

__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

__device__ __forceinline__ uint32_t& word(uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// A lane's 16 bytes: N elements of kBits, read as f32 and written back.
template <typename T> struct Lane;

template <> struct Lane<float> {
  static constexpr int N = 4, kBits = 32;
  static __device__ __forceinline__ float get(const uint4& r, int j) {
    return __uint_as_float(word(r, j));
  }
  static __device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Lane<__nv_bfloat16> {
  static constexpr int N = 8, kBits = 16;
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

// Takes the cells [x0, x1) of row y into the running maximum, in scan order.
template <typename T, bool kPos>
__device__ __forceinline__ void scan_run(const T* src, int W, int C, int nc, bool vec, int y,
                                         int x0, int x1, float (&best)[Lane<T>::N],
                                         int32_t (&arg)[Lane<T>::N]) {
  using L = Lane<T>;
#pragma unroll 4
  for (int x = x0; x < x1; ++x) {
    const int cell = y * W + x;
    const uint4 v = load_lane<T>(src + (int64_t)cell * C, nc, vec);
#pragma unroll
    for (int j = 0; j < L::N; ++j) {
      const float e = L::get(v, j);
      if (e > best[j]) {
        best[j] = e;
        if (kPos) arg[j] = cell;
      }
    }
  }
}

template <typename T, bool kPos>
__global__ void __launch_bounds__(kWarps * 32)
roi_loop_pool_fwd_kernel(const T* __restrict__ feat, int H, int W, int C, bool vec,
                         const int32_t* __restrict__ hs, const int32_t* __restrict__ he,
                         const int32_t* __restrict__ ws, const int32_t* __restrict__ we,
                         const int32_t* __restrict__ ex, const uint8_t* __restrict__ valid,
                         const float* __restrict__ row_scale, int P, int bins, int PH, int PW,
                         T* __restrict__ out, int32_t* __restrict__ pos) {
  using L = Lane<T>;
  constexpr int N = L::N;
  const int bin = blockIdx.x * kWarps + threadIdx.x / 32;   // flat (row, ph, pw)
  const int c0 = (blockIdx.y * 32 + threadIdx.x % 32) * N;  // the lane's first channel
  if (bin >= bins || c0 >= C) return;
  const int nc = min(N, C - c0);
  const int pw = bin % PW, ph = bin / PW % PH, row = bin / (PW * PH), p = row % P;

  float best[N];
  int32_t arg[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    best[j] = 0.0f;
    arg[j] = -1;
  }
  if (valid[p] != 0) {
    const int h0 = hs[row * PH + ph], h1 = he[row * PH + ph];
    const int w0 = ws[row * PW + pw], w1 = we[row * PW + pw];
    const int eh1 = ex[row * 4], eh2 = ex[row * 4 + 1];
    const int ew1 = ex[row * 4 + 2], ew2 = ex[row * 4 + 3];
    const T* src = feat + c0;
    for (int y = h0; y < h1; ++y) {
      // in a row inside the rectangle's rows, the cells ew1 < x < ew2 are out:
      // scan [w0, ew1] and then [ew2, w1)
      const bool cut = y > eh1 && y < eh2;
      const int xa = cut ? min(w1, ew1 + 1) : w1;
      const int xb = cut ? max(xa, max(w0, ew2)) : w1;
      scan_run<T, kPos>(src, W, C, nc, vec, y, w0, xa, best, arg);
      scan_run<T, kPos>(src, W, C, nc, vec, y, xb, w1, best, arg);
    }
    const float s = row_scale ? L::round(row_scale[p]) : 1.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) best[j] = best[j] * s;
  }
  const int64_t o = (int64_t)bin * C + c0;
  store_out<T>(out + o, best, nc, vec);
  if (kPos) store_pos<N>(pos + o, arg, nc, vec);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
void launch(const void* feat, int H, int W, int C, const int32_t* hs, const int32_t* he,
            const int32_t* ws, const int32_t* we, const int32_t* ex, const uint8_t* valid,
            const float* row_scale, int P, int PH, int PW, void* out, int32_t* pos,
            cudaStream_t stream) {
  constexpr int N = Lane<T>::N;
  const int bins = 3 * P * PH * PW;
  const bool vec = C % N == 0 && aligned16(feat) && aligned16(out) && (!pos || aligned16(pos));
  const dim3 grid((bins + kWarps - 1) / kWarps, ((C + N - 1) / N + 31) / 32);
  auto f = static_cast<const T*>(feat);
  auto o = static_cast<T*>(out);
  if (pos) {
    roi_loop_pool_fwd_kernel<T, true><<<grid, kWarps * 32, 0, stream>>>(
        f, H, W, C, vec, hs, he, ws, we, ex, valid, row_scale, P, bins, PH, PW, o, pos);
  } else {
    roi_loop_pool_fwd_kernel<T, false><<<grid, kWarps * 32, 0, stream>>>(
        f, H, W, C, vec, hs, he, ws, we, ex, valid, row_scale, P, bins, PH, PW, o, nullptr);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hs/he (3P, PH), ws/we (3P, PW) and ex
// (3P, 4) are int32; valid (P,) bool bytes; row_scale (P,) f32 or null; out
// (3P, PH, PW, C) and pos (same, int32, or null). Returns cudaGetLastError()
// after the launch (0 on success); P == 0 or C == 0 launches nothing.
extern "C" int sos_roi_loop_pool_fwd(int dtype, const void* feat, int H, int W, int C,
                                     const void* hs, const void* he, const void* ws,
                                     const void* we, const void* ex, const void* valid,
                                     const void* row_scale, int P, int PH, int PW, void* out,
                                     void* pos, void* stream) {
  if (P == 0 || C == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto v8 = static_cast<const uint8_t*>(valid);
  auto rs = static_cast<const float*>(row_scale);
  auto pos32 = static_cast<int32_t*>(pos);
  if (dtype == 0) {
    launch<float>(feat, H, W, C, i32(hs), i32(he), i32(ws), i32(we), i32(ex), v8, rs, P, PH,
                  PW, out, pos32, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(feat, H, W, C, i32(hs), i32(he), i32(ws), i32(we), i32(ex), v8, rs,
                          P, PH, PW, out, pos32, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
