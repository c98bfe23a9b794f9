// Multi-level ROIAlign backward for Hopper (sm_90a): the gradient of
// csrc/roi_align_fwd.cu's function with respect to each level's features.
//
// Replaces XLA's autodiff of sos_wsod_tpu/ops/roi_align.py:52 roi_align (the
// transpose of its jnp.take gathers, a scatter-add into the map), as the JAX
// package takes it through models/roi_heads/standard.py:43
// multilevel_roi_align in the stage-2 training step.
//
// What it computes. Each valid ROI pools from its own level; each of its bins
// has a grid_h x grid_w sample grid, fixed by sampling_ratio or adaptive
// (ceil(bin size), capped at cap). Sample (iy, ix) of bin (ph, pw) read four
// corners with weights w_k; the output was the sum of the samples over the
// sample count. So the gradient puts, for each channel c,
//   term_k = (g[p, ph, pw, c] / count) * w_k
// onto corner k's cell of the ROI's level, one term per corner per sample:
// the plain version's order of operations (ops/roi_align.py:
// roi_align_levels_backward_reference), each rounded to nearest. Invalid
// ROIs add nothing; out-of-bounds samples carry weight +0.
//
// The sample positions, clamps and weights are the forward's, bit for bit:
// sample_pos, axis_cells and weights below are copies of roi_align_fwd.cu's
// (tests/test_torch_roi_align_grad.py holds the copies equal, text for
// text), with the same per-ROI scaled box, bin size, grid and count.
//
// Design (the first, simple one): one block a (ROI, bin), one thread a
// channel (strided when C exceeds the block). The block's first threads
// compute the bin's sample rows and columns into shared memory (one divide
// a row or column); each thread then walks the samples, iy outer and ix
// inner, and adds its four terms with f32 atomicAdd into one zeroed f32
// buffer that holds every level's map, (H_l * W_l, C) after one another,
// as the plain version's flat map. Neighbouring threads add to neighbouring
// channels of one cell, so a warp's atomics fall on one or two 128-byte
// lines. A second kernel casts the sums into the features' dtype (bf16); in
// f32 the buffer is the gradient.
//
// What bounds it on this card: the bytes it must move are g read once and
// each level's gradient written once (at P = 512 and the 704 x 960 canvas in
// bf16, 12.8 + 28.7 MB, 12 us at 3.35 TB/s); its arithmetic is 8 f32
// operations a sample-channel (4 products, 4 adds). This design spends far
// more: one atomic a corner a channel (the sums stay in L2, where many ROIs
// of p2 and p3 add to the same cells and their atomics queue), a zeroed f32
// buffer and, in bf16, a cast pass over it. Atomics sum in a run-dependent
// order, so the result is compared with the plain version within a stated
// tolerance and is not bit-reproducible across runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxThreads = 256;
constexpr int kCastThreads = 256;

struct Levels {
  int64_t base[kMaxLevels];   // first cell of each level in the flat buffer
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// One sample row (or column): its two cells and its two weight factors,
// +0 when out of bounds.
struct Axis {
  int lo, hi;
  float l, h;
};

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

__device__ __forceinline__ void weights(const Axis& ya, const Axis& xa, float* wt) {
  wt[0] = __fmul_rn(ya.h, xa.h);
  wt[1] = __fmul_rn(ya.h, xa.l);
  wt[2] = __fmul_rn(ya.l, xa.h);
  wt[3] = __fmul_rn(ya.l, xa.l);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One block a (ROI, bin); tab: the bin's cap sample rows, then its cap
// sample columns.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) roi_align_bwd_kernel(
    Levels lv, int num_levels, int c, const float4* __restrict__ boxes,
    const int* __restrict__ level, const bool* __restrict__ valid, int ph_out, int pw_out,
    int sampling_ratio, int cap, int aligned, const T* __restrict__ grad,
    float* __restrict__ acc) {
  extern __shared__ Axis tab[];
  const int bins = ph_out * pw_out;
  const int roi = blockIdx.x / bins, bin = blockIdx.x - roi * bins;
  if (!valid[roi]) return;
  const int l = min(max(level[roi], 0), num_levels - 1);
  // pick the level with constant indices: indexing the parameter arrays with
  // l would copy them to local memory
  int64_t base = lv.base[0];
  int h = lv.h[0], w = lv.w[0];
  float scale = lv.scale[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i == l) {
      base = lv.base[i];
      h = lv.h[i];
      w = lv.w[i];
      scale = lv.scale[i];
    }
  }
  const float4 b = boxes[roi];
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
  const int ph = bin / pw_out, pw = bin - ph * pw_out;

  for (int i = threadIdx.x; i < grid_h + grid_w; i += blockDim.x) {
    if (i < grid_h)
      tab[i] = axis_cells(sample_pos(y1, bin_h, grid_h, ph, i), h);
    else
      tab[cap + i - grid_h] = axis_cells(sample_pos(x1, bin_w, grid_w, pw, i - grid_h), w);
  }
  __syncthreads();

  float* a = acc + base * c;
  const T* gb = grad + ((int64_t)roi * bins + bin) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float gc = __fdiv_rn(to_float(gb[ch]), count);
    if (gc == 0.f) continue;   // +-0 terms leave every sum as it is
    for (int iy = 0; iy < grid_h; ++iy) {
      const Axis ya = tab[iy];
      const int64_t rlo = (int64_t)ya.lo * w, rhi = (int64_t)ya.hi * w;
      for (int ix = 0; ix < grid_w; ++ix) {
        const Axis xa = tab[cap + ix];
        float wt[4];
        weights(ya, xa, wt);
        atomicAdd(a + (rlo + xa.lo) * c + ch, __fmul_rn(gc, wt[0]));
        atomicAdd(a + (rlo + xa.hi) * c + ch, __fmul_rn(gc, wt[1]));
        atomicAdd(a + (rhi + xa.lo) * c + ch, __fmul_rn(gc, wt[2]));
        atomicAdd(a + (rhi + xa.hi) * c + ch, __fmul_rn(gc, wt[3]));
      }
    }
  }
}

// The f32 sums into the features' dtype, rounded to nearest.
__global__ void cast_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                            int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(acc[i]);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16: the type of grad and of the features.
// Levels hs[l] x ws[l] with spatial scales scales[l]; boxes (p, 4) f32, level
// (p,) int32 in [0, num_levels), valid (p,) bool, grad (p, ph, pw, c), all
// contiguous. acc: f32, zeroed, sum(hs * ws) * c elements, the levels' maps
// after one another; the terms are added into it. out: for bfloat16, a
// buffer of the same element count that receives acc cast to bf16; unused
// (null) for float32, where acc is the gradient. sampling_ratio > 0 fixes
// the grid, else it is ceil(bin) capped at cap. Returns cudaGetLastError().
extern "C" int sos_roi_align_bwd(int dtype, int num_levels, const int* hs, const int* ws,
                                 const float* scales, int c, const void* boxes, const void* level,
                                 const void* valid, int p, int ph, int pw, int sampling_ratio,
                                 int cap, int aligned, const void* grad, void* acc, void* out,
                                 void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || c < 1 || ph < 1 || pw < 1 || cap < 1 ||
      p < 0 || (dtype != 0 && dtype != 1) || (dtype == 1 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)cap * sizeof(Axis);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  Levels lv;
  int64_t cells = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < num_levels ? l : 0;
    lv.base[l] = l < num_levels ? cells : 0;
    lv.h[l] = hs[k];
    lv.w[l] = ws[k];
    lv.scale[l] = scales[k];
    if (l < num_levels) cells += (int64_t)hs[l] * ws[l];
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (int64_t)p * ph * pw;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = c >= kMaxThreads ? kMaxThreads : (c + 31) / 32 * 32;
  auto b = static_cast<const float4*>(boxes);
  auto lvl = static_cast<const int*>(level);
  auto val = static_cast<const bool*>(valid);
  auto a = static_cast<float*>(acc);
  if (blocks > 0) {
    if (dtype == 0)
      roi_align_bwd_kernel<float><<<(unsigned)blocks, threads, smem, st>>>(
          lv, num_levels, c, b, lvl, val, ph, pw, sampling_ratio, cap, aligned,
          static_cast<const float*>(grad), a);
    else
      roi_align_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem, st>>>(
          lv, num_levels, c, b, lvl, val, ph, pw, sampling_ratio, cap, aligned,
          static_cast<const __nv_bfloat16*>(grad), a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dtype == 1) {
    const int64_t n = cells * c;
    int64_t grid = (n + kCastThreads - 1) / kCastThreads;
    if (grid > 132 * 16) grid = 132 * 16;
    if (grid > 0)
      cast_kernel<<<(unsigned)grid, kCastThreads, 0, st>>>(
          a, static_cast<__nv_bfloat16*>(out), n);
  }
  return (int)cudaGetLastError();
}
