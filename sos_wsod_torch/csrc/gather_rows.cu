// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :].
//
// Replaces the TPU kernel tools/bench_pallas_gather.py:68 (make_pallas_gather),
// which issues `blk` outstanding HBM->VMEM row DMAs per grid step, one per
// gathered row, waits on all of them and writes the block back. Unlike the
// Pallas kernel, whose grid is rows // blk, the last partial chunk is written
// too: every output row is written.
//
// Bound: random row reads plus contiguous writes. At the default shape (2^20
// rows of 512 bf16, 1 KB each, from a 2.94 GB table) a call moves 1 GiB in,
// 1 GiB out and 4 MiB of indices: at least 0.6423 ms at the H100's 3.35 TB/s.
// Nothing is computed; the kernel has only to keep enough bytes in flight
// (about 3.35 TB/s x 1 us, 3.4 MB over the card) and to spend no issue slots
// on the bytes themselves.
//
// The design. Every byte moves by the Tensor Memory Accelerator's 1-D bulk
// copies, through no thread's registers:
//   - Persistent blocks: the grid is min(chunks, SMs x resident blocks). A
//     block claims chunks of `blk` consecutive output rows one after another
//     from a counter in device memory (`work`, which the last block to finish
//     sets back to zero), so the chunks go out in order and a block on a
//     slower SM simply takes fewer: there is no second wave and no tail.
//     Walking chunks b, b + grid, ... instead left a tail: 0.759-0.762 ms
//     against 0.727-0.728 at the default shape (tools/bench_gather.py
//     --variants; H100 80GB HBM3, 700 W). Chunks of 32 rows keep the output
//     being written in a narrow band: 512-row chunks took 0.747-0.748 ms
//     (--sweep).
//   - A ring of S stages in dynamic shared memory, each of R consecutive
//     output rows of a chunk (or one piece of a row, where a row is larger
//     than a stage), with a "full" and an "empty" mbarrier and the stage's
//     place in the output a stage.
//   - Warp 0 loads: it claims a chunk, and for each stage reads the rows'
//     indices (int32 or int64, a lane's rows, before it waits), waits for
//     "empty", writes down the stage's place, posts its bytes with
//     mbarrier.arrive.expect_tx, and its lanes issue one cp.async.bulk
//     global -> shared a row (or piece), completing on "full". When the
//     chunks run out it posts an empty stage, which ends the storer.
//   - Lane 0 of warp 1 stores: it waits for "full", writes the stage's R
//     contiguous rows out with one cp.async.bulk shared -> global, commits
//     the bulk group, and once the store before it has read its stage
//     (cp.async.bulk.wait_group.read 1) arrives on that stage's "empty".
//   - Neither copy carries an L2 cache hint. An evict-first policy
//     (createpolicy, .L2::cache_hint) took the loads to 0.739 ms and the
//     stores to 0.728-0.729 (measured as above).
// The staged bytes are written and read by the async proxy only, so the one
// fence is the barriers' initialisation. The plan (S, R, the stage and piece
// bytes, the shared memory and the grid) is computed by the wrapper
// (kernels/gather_rows.py:plan), which the CPU tests check, and this file
// trusts it.
//
// The copy does not look at the element type: any row of a multiple of 16
// bytes, at 16-byte aligned addresses, is copied bit for bit. Indices must
// lie in [0, table rows): as for the TPU kernel, that is a precondition, and
// an index out of range is not clamped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;     // warp 0 loads, lane 0 of warp 1 stores
constexpr int kRowsPerLane = 2;  // rows a stage at most: 32 x kRowsPerLane

struct Plan {
  int stages;          // S, at least 2
  int stage_bytes;     // bytes of one stage's buffer, a multiple of 16
  int rows_per_stage;  // R, at most 32 x kRowsPerLane: a loading lane's rows
  int piece_bytes;     // bytes of a piece; row_bytes where rows go whole
  int pieces;          // pieces a row: 1 where a stage holds R whole rows
};

// One stage of a chunk [r0, r1): `count` rows from output row `row`, each
// `bytes` long at byte `offset` of its row.
struct Unit {
  int64_t row;
  int64_t offset;
  int count;
  int bytes;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int64_t units_of(const Plan& p, int64_t n) {
  return p.pieces == 1 ? (n + p.rows_per_stage - 1) / p.rows_per_stage : n * p.pieces;
}

__device__ __forceinline__ Unit unit_of(const Plan& p, int64_t r0, int64_t r1, int64_t u,
                                        int64_t row_bytes) {
  Unit s;
  if (p.pieces == 1) {
    s.row = r0 + u * p.rows_per_stage;
    s.offset = 0;
    s.count = (int)lmin(p.rows_per_stage, r1 - s.row);
    s.bytes = (int)row_bytes;
  } else {
    s.row = r0 + u / p.pieces;
    s.offset = (u % p.pieces) * (int64_t)p.piece_bytes;
    s.count = 1;
    s.bytes = (int)lmin(p.piece_bytes, row_bytes - s.offset);
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const char* __restrict__ table, const Index* __restrict__ idx,
                       int64_t rows, int64_t row_bytes, int64_t blk, char* __restrict__ out,
                       unsigned long long* work, Plan p) {
  // the stages, then a "full" and an "empty" barrier and a Unit for each
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (int64_t)p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  Unit* units = reinterpret_cast<Unit*>(empty + p.stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t chunks = (rows + blk - 1) / blk;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&] {
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  if (threadIdx.x < 32) {  // the loading warp
    for (;;) {
      int64_t c = 0;
      if (lane == 0) c = (int64_t)atomicAdd(&work[0], 1ull);
      c = __shfl_sync(0xffffffffu, c, 0);
      if (c >= chunks) break;
      const int64_t r0 = c * blk;
      const int64_t r1 = lmin(r0 + blk, rows);
      const int64_t n = units_of(p, r1 - r0);
      for (int64_t u = 0; u < n; ++u, advance()) {
        const Unit s = unit_of(p, r0, r1, u, row_bytes);
        unsigned char* buf = ring + (int64_t)stage * p.stage_bytes;
        int64_t src[kRowsPerLane];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          src[j] = lane + 32 * j < s.count ? (int64_t)__ldg(idx + s.row + lane + 32 * j) : 0;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          units[stage] = s;
          mbar_expect_tx(&full[stage], (uint32_t)(s.count * s.bytes));
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j)
          if (lane + 32 * j < s.count)
            bulk_load(buf + (lane + 32 * j) * s.bytes, table + src[j] * row_bytes + s.offset,
                      (uint32_t)s.bytes, &full[stage]);
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) {
      units[stage].count = 0;  // no more stages
      mbar_arrive(&full[stage]);
    }
  } else if (threadIdx.x == 32) {  // the storer
    int prev = -1;
    for (;; advance()) {
      mbar_wait(&full[stage], phase);
      const Unit s = units[stage];
      if (s.count == 0) break;
      bulk_store(out + s.row * row_bytes + s.offset, ring + (int64_t)stage * p.stage_bytes,
                 (uint32_t)(s.count * s.bytes));
      // the store before this one has read its stage: hand it back
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = stage;
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    // every block has claimed its last chunk: the last one out resets the counter
    __threadfence();
    if (atomicAdd(&work[1], 1ull) == gridDim.x - 1) {
      work[0] = 0;
      work[1] = 0;
    }
  }
}

template <typename Index>
int set_smem(int smem_bytes) {
  return (int)cudaFuncSetAttribute(gather_rows_kernel<Index>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

// The card's SM count and the blocks of this kernel an SM holds at
// `smem_bytes` of dynamic shared memory. Returns a CUDA error (0 on success).
extern "C" int sos_gather_rows_limits(int index_bits, int smem_bytes, int* sms,
                                      int* blocks_per_sm) {
  if (index_bits != 32 && index_bits != 64) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = index_bits == 32 ? set_smem<int32_t>(smem_bytes) : set_smem<int64_t>(smem_bytes);
  if (!err)
    err = index_bits == 32
              ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, gather_rows_kernel<int32_t>, kThreads, smem_bytes)
              : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, gather_rows_kernel<int64_t>, kThreads, smem_bytes);
  return err;
}

// table (N, row_bytes) and out (rows, row_bytes) contiguous, 16-byte aligned,
// row_bytes a positive multiple of 16; idx (rows,) int32 (index_bits 32) or
// int64 (64); blk >= 1 output rows a chunk; work two zeroed 64-bit words,
// which no other launch uses at the same time and which the kernel leaves
// zeroed. The rest is the plan of kernels/gather_rows.py, taken as it is
// given. Returns cudaGetLastError()
// after the launch (0 on success); rows == 0 launches nothing.
extern "C" int sos_gather_rows(const void* table, const void* idx, int index_bits, int64_t rows,
                               int row_bytes, int64_t blk, void* out, void* stream, void* work,
                               int stages, int stage_bytes, int rows_per_stage, int piece_bytes,
                               int pieces, int smem_bytes, int grid) {
  if (rows == 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0 || blk < 1 || grid < 1 || stages < 2 ||
      rows_per_stage < 1 || rows_per_stage > 32 * kRowsPerLane || pieces < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p{stages, stage_bytes, rows_per_stage, piece_bytes, pieces};
  auto st = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const char*>(table);
  auto o = static_cast<char*>(out);
  auto w = static_cast<unsigned long long*>(work);
  int err;
  if (index_bits == 32) {
    if ((err = set_smem<int32_t>(smem_bytes))) return err;
    gather_rows_kernel<int32_t><<<grid, kThreads, smem_bytes, st>>>(
        t, static_cast<const int32_t*>(idx), rows, row_bytes, blk, o, w, p);
  } else if (index_bits == 64) {
    if ((err = set_smem<int64_t>(smem_bytes))) return err;
    gather_rows_kernel<int64_t><<<grid, kThreads, smem_bytes, st>>>(
        t, static_cast<const int64_t*>(idx), rows, row_bytes, blk, o, w, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
