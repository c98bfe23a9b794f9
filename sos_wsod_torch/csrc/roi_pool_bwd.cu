// ROIPool backward for Hopper (sm_90a): scatter-adds the row-scaled
// cotangent of the pooled bins onto the feature map at the forward's argmax.
//
// Replaces the backward of the TPU kernel
// sos_wsod_tpu/ops/pallas/roi_pool_fused.py (_bwd, the VJP of
// roi_pool_fused), which re-runs the Pallas forward for the argmax and then
// scatter-adds in f32 with XLA. Here the forward kernel's argmax is saved by
// the autograd Function (sos_wsod_torch/ops/roi_pool.py) and passed in.
//
// Semantics (as in ops/roi_pool.py:roi_pool_backward_reference):
//   acc[pos[p,ph,pw,c], c] += float(g[p,ph,pw,c]) * rs[p]   for pos >= 0
// acc is a zeroed f32 (H, W, C) buffer; the caller casts it to the feature
// type. rs is the row scale already rounded to the feature type and widened
// to f32 (the forward multiplied by that rounded value), or null for no
// scale. The f32 atomics add in an order that changes from run to run, so
// the sums agree with the plain version to rounding, not bit for bit.
//
// Design: one thread per (bin, channel) element, a grid-stride loop over the
// P*PH*PW*C elements; neighbouring threads take neighbouring channels of one
// bin, so the reads of g and pos are coalesced and each warp's atomics land
// on 32 consecutive floats of one feature cell.
//
// Bound: at P = 4096 the kernel reads 103 M elements of g (bf16) and pos
// (int32), 0.62 GB, once, with as many f32 atomic adds. Measured on an H100
// (700 W) by chip_smoke.py: 0.91 ms at the inference canvas (87 x 119 x 512,
// a 21 MB accumulator that stays in the 50 MB L2), i.e. the stream of g and
// pos at 0.68 TB/s, 20% of the HBM peak, so the L2 atomics bound it, not the
// stream; 1.9 ms at the top training scale (152 x 204 x 512, a 64 MB
// accumulator that spills past L2), where the atomics' read-modify-writes
// reach HBM. Both bounds are the atomics'.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ g,
                                    const int32_t* __restrict__ pos,
                                    const float* __restrict__ rs, int64_t n,
                                    int C, int bins_per_roi,
                                    float* __restrict__ acc) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t q = pos[i];
    if (q < 0) continue;
    const int64_t bin = i / C;
    const int c = (int)(i - bin * C);
    float v = to_f32(g[i]);
    if (rs) v *= rs[bin / bins_per_roi];
    atomicAdd(acc + (int64_t)q * C + c, v);
  }
}

template <typename T>
void launch(const void* g, const int32_t* pos, const float* rs, int64_t n, int C,
            int bins_per_roi, float* acc, cudaStream_t stream) {
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  roi_pool_bwd_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), pos, rs, n, C, bins_per_roi, acc);
}

}  // namespace

// dtype of g: 0 = float32, 1 = bfloat16. g and pos are (P, PH, PW, C)
// contiguous; rs is (P,) f32 or null; acc is a zeroed (H, W, C) f32 buffer.
// Returns cudaGetLastError() after the launch (0 on success); P == 0
// launches nothing.
extern "C" int sos_roi_pool_bwd(int dtype, const void* g, const void* pos,
                                const void* rs, int P, int PH, int PW, int C,
                                void* acc, void* stream) {
  if (P == 0 || C == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)P * PH * PW * C;
  auto pos32 = static_cast<const int32_t*>(pos);
  auto rs32 = static_cast<const float*>(rs);
  auto acc32 = static_cast<float*>(acc);
  if (dtype == 0) {
    launch<float>(g, pos32, rs32, n, C, PH * PW, acc32, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(g, pos32, rs32, n, C, PH * PW, acc32, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
