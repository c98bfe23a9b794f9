// Row gather for Hopper (sm_90a): out[i, :] = table[idx[i], :].
//
// Replaces the TPU kernel tools/bench_pallas_gather.py:68 (make_pallas_gather),
// which issues `blk` outstanding HBM->VMEM row DMAs per grid step, one per
// gathered row, and waits on all of them before the output block is written
// back. Here each CUDA block owns `blk` consecutive output rows, as a Pallas
// grid step did, and the outstanding DMAs become loads in flight: every warp
// of the block copies ROWS_IN_FLIGHT rows at a time, and the blocks of all 132
// SMs run at once. Unlike the Pallas kernel, whose grid is rows // blk, the
// last partial block is written too: every output row is written.
//
// Bound: random row reads plus contiguous writes. At the default shape (2^20
// rows of 512 bf16, 1 KB each, from a 2.94 GB table) a call moves 1 GiB in
// and 1 GiB out, about 2.1 GB of device-memory traffic: at least 0.64 ms at
// the H100's 3.35 TB/s. Each 1 KB row is 64 16-byte vectors, two per lane;
// the table is read through the read-only path (ld.global.nc) and the output
// written with streaming stores (st.global.cs), so the 1 GiB output does not
// evict table lines from the 50 MB L2. Lane u of a warp reads index u of its
// rows and broadcasts it with __shfl_sync.
//
// The copy moves 16-byte vectors and does not look at the element type: any
// row of a multiple of 16 bytes, at 16-byte aligned addresses, is copied bit
// for bit. Indices (int32 or int64) must lie in [0, table rows): as for the
// TPU kernel, that is a precondition, and an index out of range is not
// clamped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;  // rows a warp copies at once
constexpr unsigned kFull = 0xffffffffu;

template <typename Index>
__global__ void gather_rows_kernel(const uint4* __restrict__ table,
                                   const Index* __restrict__ idx, int64_t rows,
                                   int vecs_per_row, int64_t blk,
                                   uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t begin = (int64_t)blockIdx.x * blk;
  const int64_t end = begin + blk < rows ? begin + blk : rows;
  for (int64_t r0 = begin + (int64_t)warp * kRowsInFlight; r0 < end;
       r0 += (int64_t)warps * kRowsInFlight) {
    int64_t mine = 0;
    if (lane < kRowsInFlight && r0 + lane < end) mine = (int64_t)idx[r0 + lane];
    int64_t src[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) src[u] = __shfl_sync(kFull, mine, u);
    for (int v = lane; v < vecs_per_row; v += 32) {
      uint4 buf[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (r0 + u < end) buf[u] = __ldg(table + src[u] * vecs_per_row + v);
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (r0 + u < end) __stcs(out + (r0 + u) * vecs_per_row + v, buf[u]);
    }
  }
}

}  // namespace

// table (N, row_bytes) and out (rows, row_bytes) contiguous, 16-byte aligned,
// row_bytes a positive multiple of 16; idx (rows,) int32 (index_bits 32) or
// int64 (64); blk >= 1 output rows per CUDA block. Returns cudaGetLastError()
// after the launch (0 on success); rows == 0 launches nothing.
extern "C" int sos_gather_rows(const void* table, const void* idx, int index_bits,
                               int64_t rows, int row_bytes, int64_t blk, void* out,
                               void* stream) {
  if (rows == 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0 || blk < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + blk - 1) / blk;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const uint4*>(table);
  auto o = static_cast<uint4*>(out);
  const int vecs = row_bytes / 16;
  if (index_bits == 32) {
    gather_rows_kernel<int32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        t, static_cast<const int32_t*>(idx), rows, vecs, blk, o);
  } else if (index_bits == 64) {
    gather_rows_kernel<int64_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        t, static_cast<const int64_t*>(idx), rows, vecs, blk, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
