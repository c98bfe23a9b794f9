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
// Layout: one warp per (roi, bin); the lanes split the channels, as 16-byte
// vectors where C allows (8 bf16 or 4 f32 channels a lane), else one channel
// at a time. The maps are channels-last (H_l, W_l, C), so a sample's four
// corners are four contiguous C-vectors, read as whole 512-byte rows by the
// warp at C = 256 bf16. The output is written channels-last, (P, PH, PW, C),
// in coalesced rows; the caller views it as (P, C, PH, PW).
//
// Arithmetic: the plain version's, in the same order, each step rounded to
// nearest and never contracted into an FMA: scaled = box * scale - offset;
// bin = roi / 7; y = (y1 + ph * bin_h) + y_frac * bin_h with y_frac =
// (iy + 0.5) / grid_h; the clipping and out-of-bounds rules of
// _bilinear_weights (sos_wsod_tpu/ops/roi_align.py:23); a sample is
// ((((0 + f0 w0) + f1 w1) + f2 w2) + f3 w3), added to an f32 accumulator
// from +0 with iy outer and ix inner, then one divide by the sample count and
// one rounding to the output type. The plain version also adds sample x 0
// for the samples outside a ROI's adaptive grid (up to the cap of 8); those
// terms are +-0 and leave the sum as it is, so the kernel skips them. The
// result equals the plain version bit for bit wherever the feature maps are
// finite (an inf or NaN in a cell that only a skipped sample touches would
// turn the plain version's bin NaN). Invalid ROIs give +0.
//
// Bound: the feature maps read once plus the output written once, bytes:
// at the 704 x 960 canvas, p2-p5 (176x240, 88x120, 44x60, 22x30) x 256 bf16
// are 28.7 MB and 1000 ROIs x 49 bins x 256 bf16 are 25.1 MB, 16 us at
// 3.35 TB/s. The ROIs' windows are small and overlap, so the corner reads
// hit L2; the kernel's work is the per-sample weight arithmetic, which every
// lane of a warp repeats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename T>
struct Vec;   // VEC elements of T moved as one load or store

template <>
struct Vec<float> {
  static constexpr int kWide = 4;
  __device__ static void load(const float* p, float* v, int n) {
    if (n == kWide) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      for (int i = 0; i < n; ++i) v[i] = __ldg(p + i);
    }
  }
  __device__ static void store(float* p, const float* v, int n) {
    if (n == kWide) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < n; ++i) p[i] = v[i];
    }
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWide = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v, int n) {
    if (n == kWide) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
      for (int i = 0; i < kWide; ++i) v[i] = __bfloat162float(e[i]);
    } else {
      for (int i = 0; i < n; ++i) v[i] = __bfloat162float(p[i]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v, int n) {
    if (n == kWide) {
      uint4 q;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
      for (int i = 0; i < kWide; ++i) e[i] = __float2bfloat16_rn(v[i]);
      *reinterpret_cast<uint4*>(p) = q;
    } else {
      for (int i = 0; i < n; ++i) p[i] = __float2bfloat16_rn(v[i]);
    }
  }
};

// One sample's corners and weights, the rules of _bilinear_weights.
struct Corners {
  int64_t idx[4];
  float wt[4];
};

__device__ __forceinline__ Corners bilinear(float y, float x, int h, int w) {
  Corners c;
  const bool oob = (y < -1.f) || (y > (float)h) || (x < -1.f) || (x > (float)w);
  y = y < 0.f ? 0.f : y;   // clip(min=0): NaN stays NaN
  x = x < 0.f ? 0.f : x;
  const int y_low = min((int)y, h - 1);
  const int x_low = min((int)x, w - 1);
  const int y_high = min(y_low + 1, h - 1);
  const int x_high = min(x_low + 1, w - 1);
  if (y_low >= h - 1) y = (float)(h - 1);
  if (x_low >= w - 1) x = (float)(w - 1);
  const float ly = __fsub_rn(y, (float)y_low);
  const float lx = __fsub_rn(x, (float)x_low);
  const float hy = __fsub_rn(1.f, ly);
  const float hx = __fsub_rn(1.f, lx);
  c.idx[0] = (int64_t)y_low * w + x_low;
  c.idx[1] = (int64_t)y_low * w + x_high;
  c.idx[2] = (int64_t)y_high * w + x_low;
  c.idx[3] = (int64_t)y_high * w + x_high;
  c.wt[0] = oob ? 0.f : __fmul_rn(hy, hx);
  c.wt[1] = oob ? 0.f : __fmul_rn(hy, lx);
  c.wt[2] = oob ? 0.f : __fmul_rn(ly, hx);
  c.wt[3] = oob ? 0.f : __fmul_rn(ly, lx);
  return c;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) roi_align_fwd_kernel(
    Levels lv, int num_levels, int c, const float4* __restrict__ boxes,
    const int* __restrict__ level, const bool* __restrict__ valid, int p, int ph_out,
    int pw_out, int sampling_ratio, int cap, int aligned, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t item = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int bins = ph_out * pw_out;
  if (item >= (int64_t)p * bins) return;
  const int roi = (int)(item / bins);
  const int bin = (int)(item % bins);
  T* o = out + item * c;
  float v[VEC];
  if (!valid[roi]) {
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) Vec<T>::store(o + c0, v, VEC);
    return;
  }
  const int l = min(max(level[roi], 0), num_levels - 1);
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
  const float4 b = boxes[roi];
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
  const int ph = bin / pw_out, pw = bin % pw_out;
  const float ybase = __fadd_rn(y1, __fmul_rn((float)ph, bin_h));
  const float xbase = __fadd_rn(x1, __fmul_rn((float)pw, bin_w));

  for (int c0 = lane * VEC; c0 < c; c0 += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int iy = 0; iy < grid_h; ++iy) {
      const float y_frac = __fdiv_rn((float)iy + 0.5f, (float)grid_h);
      const float y = __fadd_rn(ybase, __fmul_rn(y_frac, bin_h));
      for (int ix = 0; ix < grid_w; ++ix) {
        const float x_frac = __fdiv_rn((float)ix + 0.5f, (float)grid_w);
        const float x = __fadd_rn(xbase, __fmul_rn(x_frac, bin_w));
        const Corners cr = bilinear(y, x, h, w);
        float s[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[i] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          Vec<T>::load(f + cr.idx[k] * c + c0, v, VEC);
#pragma unroll
          for (int i = 0; i < VEC; ++i) s[i] = __fadd_rn(s[i], __fmul_rn(v[i], cr.wt[k]));
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __fdiv_rn(acc[i], count);
    Vec<T>::store(o + c0, v, VEC);
  }
}

template <typename T>
int launch(const Levels& lv, int num_levels, int c, bool wide, const void* boxes,
           const void* level, const void* valid, int p, int ph, int pw, int sampling_ratio,
           int cap, int aligned, void* out, cudaStream_t st) {
  const int64_t warps = (int64_t)p * ph * pw;
  const int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto b = static_cast<const float4*>(boxes);
  auto lvl = static_cast<const int*>(level);
  auto val = static_cast<const bool*>(valid);
  auto o = static_cast<T*>(out);
  if (wide) {
    roi_align_fwd_kernel<T, Vec<T>::kWide><<<(unsigned)blocks, kThreads, 0, st>>>(
        lv, num_levels, c, b, lvl, val, p, ph, pw, sampling_ratio, cap, aligned, o);
  } else {
    roi_align_fwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, st>>>(
        lv, num_levels, c, b, lvl, val, p, ph, pw, sampling_ratio, cap, aligned, o);
  }
  return (int)cudaGetLastError();
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
