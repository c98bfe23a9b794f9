// Greedy NMS for Hopper (sm_90a): suppression bitmasks, then one sweep per
// problem.
//
// Replaces the XLA op sos_wsod_tpu/ops/nms.py:51 nms_mask (with :75
// batched_nms_mask), whose greedy scan is the fixpoint of a masked (S, S)
// IoU > thr reduction; the port's plain version builds the same matrix and
// syncs the host once per fixpoint iteration. Both kernels here take boxes
// already sorted by score (a stable torch.sort in ops/nms.py) and their
// valid flags, for a batch of B independent problems of S boxes.
//
// nms_mask_kernel writes mask[b, i, w], a 64-bit word whose bit t says that
// box i suppresses box j = 64 w + t: j > i and IoU(i, j) > thr. Only words on
// or above the diagonal (w >= i / 64) are written; the sweep reads no other.
// A block of 64 threads owns a 64 x 64 tile: the 64 column boxes are staged
// in shared memory, each thread computes its row's 64 bits.
//
// nms_sweep_kernel takes one block per problem and walks the boxes in sorted
// order with a "removed" bitset in shared memory (64 words for S = 4096, 71
// for 4495). Warp 0 decides the 64 boxes of a word in turn, passing their
// diagonal words by shuffles: a box that is valid and not removed is kept,
// and its row joins the bitset. Then the whole block ORs the kept rows' later
// words into the bitset (shared-memory atomics). Invalid boxes are never kept
// and never suppress, so the keep mask equals the plain fixpoint's. No host
// sync. (Loading the later words ahead of the barrier and walking only the
// live boxes measured slower: the sweep's step is not bound by its loads.)
//
// Exact IoU: each step is the f32 operation of core/boxes.py:pairwise_iou,
// rounded to nearest, never contracted into an FMA (__fsub_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn): max/min of the corners (NaN if either is NaN, as
// torch.maximum), (rb - lt) clamped at 0, w * h, (area_i + area_j) - inter,
// the union > 0 guard, then inter > 0 ? inter / union : 0, compared with the
// threshold rounded to f32. A pair exactly at the threshold falls the same
// way as in the plain version, so the keep masks are bit-identical.
//
// Bound: the mask kernel writes the words on and above the diagonal,
// 64 W (W + 1) / 2 a problem for W = ceil(S / 64), 8 bytes each (21.3 MB at
// B = 20, S = 4096), and reads 16 S B bytes of boxes; the
// sweep reads at most the same words again. Its S steps are sequential: it is
// bound by latency (a shuffle chain of 64 steps and two block barriers per 64
// boxes), not by bytes, and one block per problem leaves most SMs idle when B
// is small (the RPN's B = 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // boxes per mask word
constexpr int kSweepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thr with the operations of core/boxes.py:pairwise_iou, a the
// row (boxes1) and b the column (boxes2).
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thr) {
  float w = __fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x));
  float h = __fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y));
  w = w < 0.f ? 0.f : w;   // clamp(min=0): NaN stays NaN
  h = h < 0.f ? 0.f : h;
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float safe = uni > 0.f ? uni : 1.f;
  const float iou = inter > 0.f ? __fdiv_rn(inter, safe) : 0.f;
  return iou > thr;
}

__global__ void __launch_bounds__(kTile) nms_mask_kernel(const float4* __restrict__ boxes,
                                                         int s, int words, float thr,
                                                         u64* __restrict__ mask) {
  const int rb = blockIdx.y, cb = blockIdx.x;
  if (cb < rb) return;   // below the diagonal: the sweep never reads it
  const int64_t b = blockIdx.z;
  const float4* bx = boxes + b * s;
  __shared__ float4 col[kTile];
  __shared__ float col_area[kTile];
  const int t = threadIdx.x;
  const int c0 = cb * kTile;
  const int ncol = min(kTile, s - c0);
  if (t < ncol) {
    const float4 c = bx[c0 + t];
    col[t] = c;
    col_area[t] = area(c);
  }
  __syncthreads();
  const int i = rb * kTile + t;
  if (i >= s) return;
  const float4 r = bx[i];
  const float ra = area(r);
  u64 bits = 0ull;
  for (int k = rb == cb ? t + 1 : 0; k < ncol; ++k)
    if (suppresses(r, ra, col[k], col_area[k], thr)) bits |= 1ull << k;
  mask[(b * s + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(
    const u64* __restrict__ mask, const bool* __restrict__ valid, int s, int words,
    bool* __restrict__ keep) {
  extern __shared__ u64 removed[];   // words
  __shared__ u64 kept_word;
  const int64_t b = blockIdx.x;
  const u64* m = mask + b * s * (int64_t)words;
  const bool* v = valid + b * s;
  bool* out = keep + b * s;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int wb = 0; wb < words; ++wb) {
    if (threadIdx.x < 32) {
      // the 64 boxes of word wb, decided in order by warp 0
      const int r0 = wb * kTile + lane, r1 = r0 + 32;
      const u64 d0 = r0 < s ? m[(int64_t)r0 * words + wb] : 0ull;
      const u64 d1 = r1 < s ? m[(int64_t)r1 * words + wb] : 0ull;
      const unsigned lo = __ballot_sync(kFull, r0 < s && v[r0]);
      const unsigned hi = __ballot_sync(kFull, r1 < s && v[r1]);
      const u64 live = (u64)lo | ((u64)hi << 32);
      u64 cur = removed[wb];
      u64 kw = 0ull;
      for (int t = 0; t < kTile; ++t) {
        const u64 row = __shfl_sync(kFull, t < 32 ? d0 : d1, t & 31);
        if (((live & ~cur) >> t) & 1ull) {
          kw |= 1ull << t;
          cur |= row;
        }
      }
      if (r0 < s) out[r0] = (kw >> lane) & 1ull;
      if (r1 < s) out[r1] = (kw >> (lane + 32)) & 1ull;
      if (lane == 0) kept_word = kw;
    }
    __syncthreads();
    const u64 kw = kept_word;
    const int rest = words - wb - 1;
    if (kw && rest > 0) {
      // the kept rows' later words join the bitset
      for (int idx = threadIdx.x; idx < kTile * rest; idx += blockDim.x) {
        const int t = idx / rest;
        const int w = wb + 1 + idx % rest;
        if ((kw >> t) & 1ull) atomicOr(&removed[w], m[(int64_t)(wb * kTile + t) * words + w]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (batch, s, 4) f32 contiguous, 16-byte aligned, sorted by score;
// mask (batch, s, ceil(s / 64)) 64-bit words, written on and above the
// diagonal. Returns cudaGetLastError() after the launch.
extern "C" int sos_nms_mask(const void* boxes, int batch, int s, float thr, void* mask,
                            void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (batch < 0 || s < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int words = (s + kTile - 1) / kTile;
  if (words > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), s, words, thr, static_cast<u64*>(mask));
  return (int)cudaGetLastError();
}

// mask from sos_nms_mask, valid and keep (batch, s) bool contiguous; writes
// the greedy keep mask in sorted order. Returns cudaGetLastError().
extern "C" int sos_nms_sweep(const void* mask, const void* valid, int batch, int s, void* keep,
                             void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (batch < 0 || s < 0) return (int)cudaErrorInvalidValue;
  const int words = (s + kTile - 1) / kTile;
  const size_t smem = (size_t)words * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<batch, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const bool*>(valid), s, words,
      static_cast<bool*>(keep));
  return (int)cudaGetLastError();
}
