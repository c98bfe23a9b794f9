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
// box i suppresses box j = 64 w + t: j > i and IoU(i, j) > thr. A block of
// 64 threads owns one 64 x 64 tile on or above the diagonal (a 1-D grid of
// W (W + 1) / 2 tiles a problem, W = ceil(S / 64)); the 64 column boxes are
// staged in shared memory and each thread computes its row's 64 bits. A tile
// whose 64 rows or whose 64 columns hold no valid box is not computed and its
// words are not written: the sweep ORs only kept rows, and a kept box is
// valid, so such a word is either never read or marks only invalid boxes,
// which are never kept. Invalid boxes sort to the end, so these tiles are the
// padding's.
//
// The compare, exact and with no divide. Per pair, the f32 steps of
// core/boxes.py:pairwise_iou, each rounded to nearest and never contracted
// into an FMA: w = min(x2) - max(x1) and h likewise, clamped at 0, inter =
// w * h, uni = (area_i + area_j) - inter, safe = uni > 0 ? uni : 1. The plain
// version then tests f32(inter / safe) > t with t = f32(thr). Let u be the
// next f32 above t and m = (t + u) / 2, exact in f64. Rounding to nearest is
// monotonic and m is the point where it passes from t to u, so for
// inter > 0:
//   f32(inter / safe) > t  <=>  inter > m * safe,
//                               or inter == m * safe and u's significand is
//                               even (the tie rounds to even).
// m has at most 25 significant bits and safe 24, so m * safe is exact in f64
// (53 bits; f32's range, subnormals included, is well inside f64's), and so
// is the compare. The host computes m and the tie flag once a call
// (kernels/nms.py:threshold_constants); where inter > 0 is false (0, or NaN)
// the plain IoU is 0 and the bit is 0 > t, also from the host.
// NaN once a box, not once a pair: a NaN coordinate makes w or h NaN, so
// inter is NaN and the pair's IoU is 0. A column box with a NaN, an invalid
// one and the ragged edge are staged as the empty box (+inf, +inf, -inf,
// -inf), whose intersection with any box without a NaN is 0; a row box with
// a NaN gets the bits of IoU 0. The others take plain fminf/fmaxf: the sign
// of a zero cannot change a bit, since w and h are clamped and inter must be
// > 0.
//
// nms_sweep_kernel takes one block per problem, with the "removed" bitset in
// shared memory (W words), and stops at the problem's last word holding a
// valid box (found on the device; the keep flags after it are false). Step i
// decides the 64 boxes of word i in warp 0, whose lanes hold the boxes'
// diagonal words: the candidates are the valid boxes not in the removed
// bitset, and the kept set is the fixpoint of kw = candidates & ~OR(diagonal
// words of kw), each round one warp OR (two REDUX instructions). Suppression
// runs only forward, so the fixpoint is the greedy keep after as many rounds
// as the word's longest chain of suppression (a chain of 64 steps walked box
// by box measured slower). The steps are not serial load chains:
//   - warp 0 loads step i + 1's diagonal words, valid flags and the words
//     after them before it decides step i (they do not depend on it);
//   - the kept rows' next word (i + 1), which step i + 1 needs first, is ORed
//     by warp 0 itself from those preloaded words, by a warp OR, into a
//     register carry;
//   - the other 8 warps OR the kept rows of step i into words i + 2 .. last
//     during step i + 1, one step behind, from the list of kept rows warp 0
//     leaves in shared memory: each word belongs to 1-8 threads (its
//     "ways"), each taking every ways-th kept row of the list with up to
//     kLoads independent loads in flight (lanes on consecutive words read
//     consecutive addresses), then one shuffle reduction and one plain store:
//     no division, no atomics.
// One barrier a step.
//
// Bound: the operations of the pairs the inputs need (each kept box against
// every later kept box, one test a suppressed box) over the card's f32 rate;
// bytes, S (16 + 2) B,
// bind far less. The mask words, 8 * 64 W (W + 1) / 2 bytes a problem, are
// written and read back through L2. Times: PERF.md §6 (tools/bench_nms.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // boxes per mask word
constexpr int kWorkerWarps = 8;      // sweep warps that OR the kept rows' later words
constexpr int kSweepThreads = 32 * (1 + kWorkerWarps);
constexpr int kLoads = 8;            // loads a sweep worker keeps in flight
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__device__ __forceinline__ bool has_nan(float4 b) {
  return b.x != b.x || b.y != b.y || b.z != b.z || b.w != b.w;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// f32(inter / safe) > t for inter > 0, by the argument above.
__device__ __forceinline__ bool above(float inter, float safe, double m, bool tie_up) {
  const double x = (double)inter, y = __dmul_rn(m, (double)safe);
  return tie_up ? x >= y : x > y;
}

__global__ void __launch_bounds__(kTile) nms_mask_kernel(
    const float4* __restrict__ boxes, const bool* __restrict__ valid, int s, int words,
    double m, bool tie_up, bool zero_suppresses, u64* __restrict__ mask) {
  // tile q of the upper triangle, column by column: q = cb (cb + 1) / 2 + rb
  const int64_t q = blockIdx.x;
  int64_t cb = (int64_t)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
  while (cb * (cb + 1) / 2 > q) --cb;
  while ((cb + 1) * (cb + 2) / 2 <= q) ++cb;
  const int rb = (int)(q - cb * (cb + 1) / 2);
  const int64_t b = blockIdx.y;
  const float4* bx = boxes + b * s;
  const bool* v = valid + b * s;
  const int t = threadIdx.x;
  const int i = rb * kTile + t, j = (int)cb * kTile + t;
  const bool row_valid = i < s && v[i];
  const bool col_valid = j < s && v[j];
  if (!__syncthreads_or(row_valid) || !__syncthreads_or(col_valid)) return;

  __shared__ float4 col[kTile];
  __shared__ float col_area[kTile];
  const float inf = __int_as_float(0x7f800000);
  float4 c = make_float4(inf, inf, -inf, -inf);   // the empty box
  if (col_valid) {
    const float4 cv = bx[j];
    if (!has_nan(cv)) c = cv;
  }
  col[t] = c;
  col_area[t] = area(c);
  __syncthreads();
  if (i >= s) return;
  const float4 r = bx[i];
  u64 bits;
  if (row_valid && !has_nan(r)) {
    const float ra = area(r);
    bits = 0ull;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float4 cc = col[k];
      const float w = fmaxf(__fsub_rn(fminf(r.z, cc.z), fmaxf(r.x, cc.x)), 0.f);
      const float h = fmaxf(__fsub_rn(fminf(r.w, cc.w), fmaxf(r.y, cc.y)), 0.f);
      const float inter = __fmul_rn(w, h);
      const float uni = __fsub_rn(__fadd_rn(ra, col_area[k]), inter);
      const float safe = uni > 0.f ? uni : 1.f;
      const bool sup = inter > 0.f ? above(inter, safe, m, tie_up) : zero_suppresses;
      bits |= (u64)sup << k;
    }
  } else {
    bits = zero_suppresses ? ~0ull : 0ull;   // IoU 0 with every box (or never kept)
  }
  if (rb == cb) bits &= t == kTile - 1 ? 0ull : ~0ull << (t + 1);   // j > i only
  mask[(b * s + i) * words + cb] = bits;
}

// The OR of a 64-bit word over the warp (two REDUX instructions).
__device__ __forceinline__ u64 warp_or(u64 x) {
  return (u64)__reduce_or_sync(kFull, (unsigned)x) |
         ((u64)__reduce_or_sync(kFull, (unsigned)(x >> 32)) << 32);
}

__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(
    const u64* __restrict__ mask, const bool* __restrict__ valid, int s, int words,
    bool* __restrict__ keep) {
  extern __shared__ u64 removed[];   // words
  __shared__ int kept[2][kTile + 1];  // step i's kept rows (count, then the rows in order),
                                     // read by the workers in step i + 1
  __shared__ int warp_last[1 + kWorkerWarps];
  const int64_t b = blockIdx.x;
  const u64* mb = mask + b * s * (int64_t)words;
  const bool* v = valid + b * s;
  bool* out = keep + b * s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the last valid box, hence the last word the sweep decides
  int lv = -1;
  for (int r = threadIdx.x; r < s; r += kSweepThreads)
    if (v[r]) lv = r;
  lv = __reduce_max_sync(kFull, lv);
  if (lane == 0) warp_last[warp] = lv;
  for (int w = threadIdx.x; w < words; w += kSweepThreads) removed[w] = 0ull;
  __syncthreads();
  for (int k = 0; k <= kWorkerWarps; ++k) lv = max(lv, warp_last[k]);
  const int last = lv < 0 ? -1 : lv / kTile;
  for (int r = (last + 1) * kTile + threadIdx.x; r < s; r += kSweepThreads) out[r] = false;

  // warp 0: rows lane and lane + 32 of word i at words i (diagonal) and i + 1
  u64 d0 = 0ull, d1 = 0ull, n0 = 0ull, n1 = 0ull, carry = 0ull;
  bool a0 = false, a1 = false;
  auto load_rows = [&](int wb, u64& e0, u64& e1, u64& f0, u64& f1, bool& g0, bool& g1) {
    const int r0 = wb * kTile + lane, r1 = r0 + 32;
    const bool next = wb + 1 <= last;
    e0 = r0 < s ? mb[(int64_t)r0 * words + wb] : 0ull;
    e1 = r1 < s ? mb[(int64_t)r1 * words + wb] : 0ull;
    f0 = next && r0 < s ? mb[(int64_t)r0 * words + wb + 1] : 0ull;
    f1 = next && r1 < s ? mb[(int64_t)r1 * words + wb + 1] : 0ull;
    g0 = r0 < s && v[r0];
    g1 = r1 < s && v[r1];
  };
  if (warp == 0 && last >= 0) load_rows(0, d0, d1, n0, n1, a0, a1);

  for (int i = 0; i <= last; ++i) {
    if (warp == 0) {
      u64 e0 = 0ull, e1 = 0ull, f0 = 0ull, f1 = 0ull;
      bool g0 = false, g1 = false;
      if (i + 1 <= last) load_rows(i + 1, e0, e1, f0, f1, g0, g1);   // ahead of the decision
      const u64 live = (u64)__ballot_sync(kFull, a0) | ((u64)__ballot_sync(kFull, a1) << 32);
      // the greedy keep of the word's candidates, as the fixpoint of
      // kw = cand & ~OR(rows of kw): suppression runs only forward, so it is
      // exact after as many rounds as the longest chain of suppression
      const u64 cand = live & ~(removed[i] | carry);
      u64 kw = cand, before;
      do {
        before = kw;
        kw = cand & ~warp_or((((kw >> lane) & 1ull) ? d0 : 0ull) |
                             (((kw >> (lane + 32)) & 1ull) ? d1 : 0ull));
      } while (kw != before);
      const int r0 = i * kTile + lane, r1 = r0 + 32;
      if (r0 < s) out[r0] = (kw >> lane) & 1ull;
      if (r1 < s) out[r1] = (kw >> (lane + 32)) & 1ull;
      // the kept rows' word i + 1, from the preloaded words
      carry = warp_or((((kw >> lane) & 1ull) ? n0 : 0ull) |
                      (((kw >> (lane + 32)) & 1ull) ? n1 : 0ull));
      // the kept rows as a list, for the workers
      const unsigned lo = (unsigned)kw, hi = (unsigned)(kw >> 32), below = (1u << lane) - 1u;
      int* list = kept[i & 1];
      if ((lo >> lane) & 1u) list[1 + __popc(lo & below)] = lane;
      if ((hi >> lane) & 1u) list[1 + __popc(lo) + __popc(hi & below)] = lane + 32;
      if (lane == 0) list[0] = __popc(lo) + __popc(hi);
      d0 = e0; d1 = e1; n0 = f0; n1 = f1; a0 = g0; a1 = g1;
    } else if (i > 0) {
      // step i - 1's kept rows into words i + 1 .. last
      const int* list = kept[(i - 1) & 1];
      const int count = list[0];
      const int n = last - i;
      if (count > 0 && n > 0) {
        const int ways = n <= 32 ? 8 : n <= 64 ? 4 : n <= 128 ? 2 : 1;
        const int shift = __ffs(ways) - 1;
        const u64* rows = mb + (int64_t)(i - 1) * kTile * words;
        const int wt = threadIdx.x - 32;
        for (int base = 0; base < (n << shift); base += 32 * kWorkerWarps) {
          const int idx = base + wt;
          const int part = idx & (ways - 1);
          const int w = i + 1 + (idx >> shift);
          u64 acc = 0ull;
          if (idx < (n << shift)) {
            for (int k0 = part; k0 < count; k0 += ways * kLoads) {
              u64 got[kLoads];
#pragma unroll
              for (int k = 0; k < kLoads; ++k) {
                const int kk = k0 + k * ways;
                got[k] = kk < count ? rows[(int64_t)list[1 + kk] * words + w] : 0ull;
              }
#pragma unroll
              for (int k = 0; k < kLoads; ++k) acc |= got[k];
            }
          }
          for (int off = 1; off < ways; off <<= 1) acc |= __shfl_xor_sync(kFull, acc, off);
          if (idx < (n << shift) && part == 0) removed[w] |= acc;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (batch, s, 4) f32 contiguous, 16-byte aligned, sorted by score, and
// valid (batch, s) bool in the same order; m, tie_up and zero_suppresses
// from the threshold (kernels/nms.py:threshold_constants); mask (batch, s,
// ceil(s / 64)) 64-bit words, written on and above the diagonal where the
// tile holds a valid row and a valid column. Returns cudaGetLastError().
extern "C" int sos_nms_mask(const void* boxes, const void* valid, int batch, int s, double m,
                            int tie_up, int zero_suppresses, void* mask, void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (batch < 0 || s < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int words = (s + kTile - 1) / kTile;
  if (words > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((int64_t)words * (words + 1) / 2), batch);
  nms_mask_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const bool*>(valid), s, words, m,
      tie_up != 0, zero_suppresses != 0, static_cast<u64*>(mask));
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
