// ROIPool forward for Hopper (sm_90a): channels-last max pool of one
// (H, W, C) feature map into (P, PH, PW, C) bins, with first-hit argmax.
//
// Replaces the TPU kernel sos_wsod_tpu/ops/pallas/roi_pool_fused.py
// (_roi_pool_fused_fwd_impl / _make_kernel). The Pallas kernel encodes
// (value, position) into int32 keys and keeps a vertical doubling table in
// VMEM; none of that is needed here. This kernel reads the feature map as it
// is and scans each bin's window directly.
//
// Semantics (torchvision RoIPool, as in sos_wsod_torch/ops/roi_pool.py):
//   - bin windows [hs, he) x [ws, we) come in precomputed as int32 (P, PH)
//     and (P, PW) from ops/roi_pool.py:bin_windows, so the window math
//     exists once, in PyTorch;
//   - the window is scanned h-major then w with a strict '>' comparison, so
//     ties go to the first hit: the smallest flat y*W+x;
//   - out = T(float(max) * float(T(row_scale[p]))): the scale is cast to the
//     feature type first and the product, exact in f32 for bf16 operands,
//     is rounded once, which is bit-identical to a bf16 x bf16 multiply;
//   - empty windows and invalid slots give 0 and pos -1; pos may be null.
//
// Bound: at the production shape the feature map is 87 x 119 x 512 bf16,
// 10.6 MB, which stays resident in the 50 MB L2. Every bin re-reads its
// window's cells, so the kernel is bound by L2 reads of window cells, not by
// HBM. Design: one thread block per (roi, ph); threads over channels, so a
// warp reads neighbouring channels of one cell (coalesced NHWC reads); the
// loop over pw runs inside the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ feat, int H, int W, int C,
                                    const int32_t* __restrict__ hs,
                                    const int32_t* __restrict__ he,
                                    const int32_t* __restrict__ ws,
                                    const int32_t* __restrict__ we,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ row_scale,
                                    int PH, int PW, T* __restrict__ out,
                                    int32_t* __restrict__ pos) {
  const int p = blockIdx.x;
  const int ph = blockIdx.y;
  const int h0 = hs[p * PH + ph];
  const int h1 = he[p * PH + ph];
  const bool row_live = valid[p] != 0 && h1 > h0;
  const float s = row_scale ? to_f32(from_f32<T>(row_scale[p])) : 1.0f;

  for (int pw = 0; pw < PW; ++pw) {
    const int w0 = ws[p * PW + pw];
    const int w1 = we[p * PW + pw];
    const bool live = row_live && w1 > w0;
    const int64_t obase = ((int64_t)(p * PH + ph) * PW + pw) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float v_out = 0.0f;
      int32_t arg = -1;
      if (live) {
        float best = to_f32(feat[((int64_t)h0 * W + w0) * C + c]);
        arg = h0 * W + w0;
        for (int y = h0; y < h1; ++y) {
          const T* row = feat + (int64_t)y * W * C + c;
          for (int x = w0; x < w1; ++x) {
            const float v = to_f32(row[(int64_t)x * C]);
            if (v > best) {
              best = v;
              arg = y * W + x;
            }
          }
        }
        v_out = best * s;
      }
      out[obase + c] = from_f32<T>(v_out);
      if (pos) pos[obase + c] = arg;
    }
  }
}

template <typename T>
void launch(const void* feat, int H, int W, int C, const int32_t* hs,
            const int32_t* he, const int32_t* ws, const int32_t* we,
            const uint8_t* valid, const float* row_scale, int P, int PH, int PW,
            void* out, int32_t* pos, cudaStream_t stream) {
  const int threads = C < 128 ? ((C + 31) / 32) * 32 : 128;
  dim3 grid(P, PH);
  roi_pool_fwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feat), H, W, C, hs, he, ws, we, valid, row_scale,
      PH, PW, static_cast<T*>(out), pos);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); P == 0 launches nothing.
extern "C" int sos_roi_pool_fwd(int dtype, const void* feat, int H, int W, int C,
                                const void* hs, const void* he, const void* ws,
                                const void* we, const void* valid,
                                const void* row_scale, int P, int PH, int PW,
                                void* out, void* pos, void* stream) {
  if (P == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  if (dtype == 0) {
    launch<float>(feat, H, W, C, i32(hs), i32(he), i32(ws), i32(we),
                  static_cast<const uint8_t*>(valid),
                  static_cast<const float*>(row_scale), P, PH, PW, out,
                  static_cast<int32_t*>(pos), st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(feat, H, W, C, i32(hs), i32(he), i32(ws), i32(we),
                          static_cast<const uint8_t*>(valid),
                          static_cast<const float*>(row_scale), P, PH, PW, out,
                          static_cast<int32_t*>(pos), st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
