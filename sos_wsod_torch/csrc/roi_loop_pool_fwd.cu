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
// What binds it: the window cells, not HBM. At that shape (4000 proposals in
// 4096 slots) the box rows' windows hold 3,031,795 cells, the frame rows'
// kept cells 2,291,536 (a subset of the box's) and the context rows' kept
// cells 4,777,867: 10.10 M cells, 10.3 GB at 512 bf16 channels, for a map of
// 10,353 cells (10.6 MB), each cell read about 1,000 times. The first design
// (a warp a bin, 16 bytes of channels a lane, one channel compared at a time
// in f32) read all of them from L2 and took 4x its bound. At the top
// training map, 152 x 204, the counts are 7.34 M, 5.33 M and 11.88 M.
//
// Design:
//   - A work item is a (ROI, bin) pair of the box and frame rows together,
//     or a bin of a context row. The box-and-frame item reads each cell of
//     the bin's window once, in scan order, and folds it once: into the
//     frame's maximum, or, where it lies strictly inside the frame's inner
//     rectangle (ex of row P + p), into the inner cells' maximum. A row that
//     crosses the rectangle is walked as three runs, so no cell is tested.
//     The box's answer is the first hit over the two (merge: the larger
//     value, of equal ones the smaller position). That is 7.81 M cells read
//     and folded instead of 10.10 M. The fusion is the interface's contract:
//     the frame rows' windows are the box rows' and the box rows'
//     rectangles exclude nothing, as ops/roi_loop_pool.py:loop_windows makes
//     them (kernels/roi_loop_pool.py checks it before every launch), so the
//     kernel reads the box rows' windows and the frame rows' rectangles only.
//     The context item skips its excluded run without loading it.
//   - A warp answers one item at a time, its 32 lanes 16 bytes of channels
//     each (8 bf16, 4 f32): every lane runs the same loop, and a warp's load
//     or store of a cell is 512 contiguous bytes.
//   - bf16 compares two channels an instruction (__hgt2_mask) and keeps the
//     maximum and the argmax as bit selects of 32-bit words, the argmax as
//     16-bit offsets from a first cell, two to a word, expanded to int32
//     flat positions at the store (kernel A fwd's idiom, csrc/roi_pool_fwd.cu).
//     Without pos the maximum is __hmax2, one instruction a pair: the running
//     maximum is never -0 or NaN (it starts at +0 and only grows), and
//     __hmax2 returns the other operand for a NaN and +0 for (-0, +0), so it
//     equals the strict '>' fold bit for bit. f32 compares one channel at a
//     time and keeps int32 positions.
//   - Staged branch (C a multiple of 8 bf16 or 4 f32, the pointers 16-byte
//     aligned, W <= kTiledMaxW, PH and PW <= 32): the map is cut into tiles
//     of kStride x kStride cells, and a block takes one tile and one group
//     of 32 lanes' channels (512 bytes a cell). It stages the region of
//     kRegion x kRegion cells from the tile's corner into shared memory
//     (cp.async, 204,800 bytes), then answers the items of the valid ROIs
//     whose window's first cell lies in the tile, so each item is answered
//     by exactly one tile. A window of up to kMaxWin cells a side lies in
//     the region and is read from shared memory, a warp reading one cell's
//     512 contiguous bytes without bank conflicts; a larger one is read from
//     the map. At 87 x 119 x 512 bf16 that is 11 x 15 tiles, 99.1% of the
//     7.81 M cells from shared memory and 0.19 GB of the map from L2 (the
//     first design: 10.3 GB); at 152 x 204, 70% and 6.1 GB.
//   - Finding the items: a block's warps take its ROI rows (each ROI's
//     box-and-frame row, then its context row, then each ROI once more for
//     the invalid ones) kGrab at a time from a counter in shared memory, so
//     they stay busy until the block's last item. A lane tests a ROI row's
//     window corners against the tile; for each ROI row with a corner here,
//     its bin rows' and columns' windows are loaded once, a lane a row and a
//     column, two ballots give its items, and shuffles hand each item its
//     window. An invalid ROI's items (zeros and -1, all with a zero box's
//     window) go to tile (p PH PW + bin) mod tiles instead of all to the
//     first.
//   - Balance: bins crowd where boxes and their outer boxes are clipped at
//     the map's edges, so tiles differ in work by up to 2x. The blocks take
//     the tiles from the last one (the bottom right, the heaviest in the
//     main path's inputs), and where the map has fewer than kMinBlocks
//     tile-groups a tile's ROI rows are dealt in turns to two or more blocks
//     (660 blocks at 87 x 119 bf16). In turns at 87 x 119 bf16 with pos
//     (PERF.md section 6): 1.19-1.25 ms in the first order, 1.13-1.19
//     unsplit, 1.10-1.15 as then built.
//   - Direct branch, for every other shape (C not a multiple of the vector
//     width, misaligned pointers, maps wider than kTiledMaxW): a warp an
//     item, the grid over the items and the channel ranges, every cell read
//     from the map, 4 cells a run loaded before they are compared.
//   - Where a window is read from the map (the direct branch, and windows
//     larger than the region), offsets run from a chunk's first cell; a
//     chunk is as many whole rows as keep them below 0xffff, and its offsets
//     are turned into flat positions where the chunk raised the maximum, so
//     the first hit holds across chunks (the wrapper takes W <= 65535).
//   - The branch is chosen from the shape, the type and the pointers'
//     alignment alone, and sos_roi_loop_pool_fwd returns the one it took.
//     Neither is a fallback of the other.
//   - out and pos are stored as 16-byte vectors with the evict-first hint
//     (st.global.cs; plain stores measured 1.14-1.17 ms against 1.10-1.15
//     in the same build): a warp writes 512 contiguous bytes of out and 1 KB
//     of pos a row.
//   - What binds it now: at 87 x 119 bf16 with pos, 0.945-0.968 ms against
//     the 0.555 ms bound (without pos 0.56-0.58 against 0.187), with the
//     map's cells no longer read from L2: the instructions of the scan (a
//     cell takes a 16-byte load, 4 paired compares and 8 bit selects with
//     pos, 4 maxima without), of each row's runs and of each item's
//     epilogue, and the 1.85 GB of stores, which the scan overlaps only in
//     part.
//   - Tried and measured (PERF.md section 6): a block holding a 16-byte
//     channel slice of the whole map and a thread an item. Its lanes took
//     unrelated windows, so their loops diverged, and its 16-byte stores,
//     1 KB apart, cost more than the scan: 4.3 ms with pos against the
//     first design's 2.3.
// Times, beside the bound and the first design's: PERF.md section 6,
// measured by sos_wsod_torch/tools/bench_roi_loop_pool.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // direct branch: work items a block, one warp each
constexpr int kTileThreads = 1024; // staged branch: threads a block
constexpr int kRegion = 20;        // staged branch: a tile stages kRegion x kRegion cells
constexpr int kMaxWin = 13;        // windows up to this many cells a side fit from any corner
constexpr int kStride = kRegion - kMaxWin + 1;  // a tile owns the windows whose corner is in
                                               // its kStride x kStride cells
constexpr int kCellVecs = 32;      // 16-byte vectors of a staged cell: a warp's 32 lanes
constexpr int kSpan = 65535;       // 16-bit offsets lie below this (0xffff); kSpan marks none
constexpr int kTiledMaxW = 3448;   // widest map of the staged branch: a staged window's
                                   // offsets, below (kRegion - 1) W + kRegion, stay below kSpan
static_assert(kTiledMaxW <= (kSpan - kRegion) / (kRegion - 1), "staged offsets exceed 16 bits");
constexpr int kUnroll = 2;         // cells of a run loaded before they are compared: from
constexpr int kUnrollMap = 4;      // shared memory, and from the map (L2's longer latency)
constexpr int kGrab = 32;          // ROI rows a staged warp takes from the counter at a time
constexpr int kMinBlocks = 600;    // staged blocks at the least: each tile's ROI rows are dealt
                                   // in turns to as many blocks as that takes (split)

__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

__device__ __forceinline__ uint32_t& word(uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// A lane's 16 bytes of channels, kept as raw bits: N elements of kBits.
// fold() takes one more cell of the scan into the running maximum `best`
// (raw bits too) and, with kPos, its position into the Track: an element is
// replaced only where the new value is strictly greater. resolve() turns a
// Track into flat positions in `arg` where it holds one.
template <typename T> struct Lane;

template <> struct Lane<float> {
  static constexpr int N = 4, kBits = 32;
  struct Track {
    int32_t cell[N];  // flat position, -1 where none
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
// way, as 16-bit offsets from a first cell, two to a word (`offset2` holds
// the cell's offset in both halves), so one more bit select tracks both
// channels' argmax.
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
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t w) {
    return *reinterpret_cast<const __nv_bfloat162*>(&w);
  }
  static __device__ __forceinline__ uint32_t unpair(__nv_bfloat162 p) {
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  struct Track {
    uint4 off;  // 16-bit offsets from the first cell, kSpan where none
  };
  static __device__ __forceinline__ Track track() {
    return Track{make_uint4(~0u, ~0u, ~0u, ~0u)};
  }
  template <bool kPos>
  static __device__ __forceinline__ void fold(uint4& best, Track& t, const uint4& v,
                                              int /*cell*/, uint32_t offset2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kPos) {
        const uint32_t m = __hgt2_mask(pair(word(v, k)), pair(word(best, k)));
        word(best, k) = (word(v, k) & m) | (word(best, k) & ~m);
        word(t.off, k) = (offset2 & m) | (word(t.off, k) & ~m);
      } else {
        word(best, k) = unpair(__hmax2(pair(word(v, k)), pair(word(best, k))));
      }
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

// The running maximum of one output row and its argmax. Chunked (the direct
// branch): the Track's offsets run from the current chunk's first cell and
// are resolved into `arg` when the chunk ends. Not chunked (the staged
// branch): the offsets are flat positions, resolved once at the store.
template <typename T, bool kPos, bool kChunked>
struct Acc {
  using L = Lane<T>;
  static constexpr int N = L::N;
  uint4 best;
  typename L::Track t;
  int32_t arg[kChunked ? N : 1];

  __device__ __forceinline__ void init() {
    best = make_uint4(0, 0, 0, 0);
    t = L::track();
    if constexpr (kChunked) {
#pragma unroll
      for (int j = 0; j < N; ++j) arg[j] = -1;
    }
  }
  __device__ __forceinline__ void fold(const uint4& v, int cell, uint32_t offset2) {
    L::template fold<kPos>(best, t, v, cell, offset2);
  }
  __device__ __forceinline__ void flush(int first) {
    if constexpr (kChunked && kPos) {
      L::resolve(t, arg, first);
      t = L::track();
    }
  }
  __device__ __forceinline__ void positions(int32_t (&out)[N], int first) {
    if constexpr (kChunked) {
      flush(first);
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = arg[j];
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = -1;
      L::resolve(t, out, first);
    }
  }
};

// A scan's answer: the maximum's raw bits and, with kPos, its flat
// positions (-1 where none).
template <typename T, bool kPos>
struct Answer {
  uint4 best;
  int32_t arg[kPos ? Lane<T>::N : 1];
};

template <typename T, bool kPos, bool kChunked>
__device__ __forceinline__ Answer<T, kPos> answer_of(Acc<T, kPos, kChunked>& acc, int first) {
  Answer<T, kPos> r;
  r.best = acc.best;
  if constexpr (kPos) acc.positions(r.arg, first);
  return r;
}

// a = the first hit of the maximum over the cells of a and b, two scans of
// disjoint cells: the larger value, and of equal ones the smaller position
// (none, -1, is the largest unsigned). The maxima are never -0 or NaN.
template <typename T, bool kPos>
__device__ __forceinline__ void merge(Answer<T, kPos>& a, const Answer<T, kPos>& b) {
  using L = Lane<T>;
#pragma unroll
  for (int j = 0; j < L::N; ++j) {
    const float va = L::get(a.best, j), vb = L::get(b.best, j);
    bool take = vb > va;
    if constexpr (kPos) take = take || (vb == va && (uint32_t)b.arg[j] < (uint32_t)a.arg[j]);
    if (take) {
      const int k = j * L::kBits / 32, sh = j * L::kBits % 32;
      const uint32_t mask = (L::kBits == 32 ? ~0u : 0xffffu) << sh;
      word(a.best, k) = (word(a.best, k) & ~mask) | (word(b.best, k) & mask);
      if constexpr (kPos) a.arg[j] = b.arg[j];
    }
  }
}

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

// A store with the evict-first hint: out and pos are not read again here.
template <typename V>
__device__ __forceinline__ void put(V* dst, V v) {
  __stcs(dst, v);
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
    put(reinterpret_cast<uint4*>(dst), r);
    return;
  }
#pragma unroll
  for (int j = 0; j < L::N; ++j) {
    if (j < n) {
      if (L::kBits == 16) {
        put(reinterpret_cast<unsigned short*>(dst) + j, (unsigned short)L::bits(v[j]));
      } else {
        put(reinterpret_cast<unsigned int*>(dst) + j, L::bits(v[j]));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void store_pos(int32_t* dst, const int32_t (&a)[N], int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      put(reinterpret_cast<int4*>(dst) + q,
          make_int4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < n) put(dst + j, a[j]);
  }
}

// Cells of a staged tile: the lane's 16-byte vector of each cell of the
// region [y0, y0 + ny) x [x0, x0 + nx), kCellVecs vectors a cell.
struct SharedCells {
  const uint4* cells;  // the region's first cell, at the lane's vector
  int y0, x0, nx;
  __device__ __forceinline__ uint4 operator()(int y, int x, int /*cell*/) const {
    return cells[((y - y0) * nx + (x - x0)) * kCellVecs];
  }
};

// Cells of the lane's channels, read from the map in global memory.
template <typename T>
struct GlobalCells {
  const T* src;  // the map at the lane's first channel
  int C, nc;
  bool vec;
  __device__ __forceinline__ uint4 operator()(int /*y*/, int /*x*/, int cell) const {
    return load_lane<T>(src + (int64_t)cell * C, nc, vec);
  }
};

// Folds the cells [x0, x1) of row y into a, in scan order.
template <int kUnroll, class A, class Load>
__device__ __forceinline__ void run(const Load& load, int y, int row, int x0, int x1, int first,
                                    A& a) {
#pragma unroll kUnroll
  for (int x = x0; x < x1; ++x) {
    const int cell = row + x;
    const uint4 v = load(y, x, cell);
    a.fold(v, cell, (uint32_t)(cell - first) * 0x10001u);
  }
}

// The window's row y splits at the exclusion rectangle ex = (h1, h2, w1, w2):
// [w0, xa) and [xb, w1) are kept, [xa, xb) lies strictly inside it (empty in
// a row outside h1 < y < h2).
__device__ __forceinline__ void split(int y, int w0, int w1, const int4& ex, int& xa, int& xb) {
  const bool cut = y > ex.x && y < ex.y;
  xa = cut ? max(w0, min(w1, ex.z + 1)) : w1;
  xb = cut ? max(xa, min(w1, ex.w)) : w1;
}

// The first cell of the current chunk, moved to row y's first cell where
// row y's last cell would lie kSpan or more past it (the direct branch's
// 16-bit offsets); the accumulators resolve what the chunk found first.
template <class A>
__device__ __forceinline__ void next_chunk(int row, int w0, int w1, int& first, A& a, A* b) {
  if (row + w1 - 1 - first >= kSpan) {
    a.flush(first);
    if (b) b->flush(first);
    first = row + w0;
  }
}

// One row's window with its exclusion rectangle, into a.
template <bool kChunked, int kUnroll, class A, class Load>
__device__ __forceinline__ int scan_one(const Load& load, int W, int h0, int h1, int w0, int w1,
                                        const int4& ex, A& a) {
  int first = h0 * W + w0;
  for (int y = h0; y < h1; ++y) {
    const int row = y * W;
    if constexpr (kChunked) next_chunk<A>(row, w0, w1, first, a, nullptr);
    int xa, xb;
    split(y, w0, w1, ex, xa, xb);
    run<kUnroll>(load, y, row, w0, xa, first, a);
    run<kUnroll>(load, y, row, xb, w1, first, a);
  }
  return first;
}

// The box and frame rows of one bin, whose window is the same: each cell
// read once, in scan order, into frame where it lies outside the frame's
// rectangle ex and into inner where it lies strictly inside; the box's
// answer is then the first hit over both (merge).
template <bool kChunked, int kUnroll, class A, class Load>
__device__ __forceinline__ int scan_two(const Load& load, int W, int h0, int h1, int w0, int w1,
                                        const int4& ex, A& frame, A& inner) {
  int first = h0 * W + w0;
  for (int y = h0; y < h1; ++y) {
    const int row = y * W;
    if constexpr (kChunked) next_chunk<A>(row, w0, w1, first, frame, &inner);
    int xa, xb;
    split(y, w0, w1, ex, xa, xb);
    run<kUnroll>(load, y, row, w0, xa, first, frame);
    run<kUnroll>(load, y, row, xa, xb, first, inner);
    run<kUnroll>(load, y, row, xb, w1, first, frame);
  }
  return first;
}

struct Args {
  int H, W, C, P, PH, PW;
  const int32_t *hs, *he, *ws, *we, *ex;
  const uint8_t* valid;
  const float* row_scale;
};

// A work item's bin window and rectangle: the context row's own, or, for a
// box-and-frame item, the box row's window and the frame row's rectangle.
struct Window {
  int h0, h1, w0, w1;
  int4 ex;
};

__device__ __forceinline__ int4 rect(const Args& a, int row) {
  const int* e = a.ex + row * 4;
  return make_int4(__ldg(e), __ldg(e + 1), __ldg(e + 2), __ldg(e + 3));
}

__device__ __forceinline__ Window window(const Args& a, int row, int ph, int pw, int ex_row) {
  return Window{__ldg(a.hs + row * a.PH + ph), __ldg(a.he + row * a.PH + ph),
                __ldg(a.ws + row * a.PW + pw), __ldg(a.we + row * a.PW + pw), rect(a, ex_row)};
}

// A staged tile: the region [y0, y0 + ny) x [x0, x0 + nx) of the map in
// shared memory. holds(): whether a window's cells all lie in it.
struct Tile {
  const uint4* cells;
  int y0, x0, ny, nx;
  __device__ __forceinline__ bool holds(const Window& w) const {
    return w.h1 <= w.h0 || w.w1 <= w.w0 ||
           (w.h0 >= y0 && w.h1 <= y0 + ny && w.w0 >= x0 && w.w1 <= x0 + nx);
  }
};

template <typename T, bool kPos>
__device__ __forceinline__ void store_row(const Args& a, int row, int bin, int c0, int nc,
                                          bool vec, bool live, float s, const Answer<T, kPos>& r,
                                          T* out, int32_t* pos) {
  using L = Lane<T>;
  constexpr int N = L::N;
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = live ? L::get(r.best, j) * s : 0.0f;
  const int64_t o = ((int64_t)row * a.PH * a.PW + bin) * a.C + c0;
  store_out<T>(out + o, v, nc, vec);
  if constexpr (kPos) store_pos<N>(pos + o, r.arg, nc, vec);
}

// One row's bin over window w (its own rectangle): scanned if live, stored.
template <typename T, bool kPos, bool kChunked, class Load>
__device__ __forceinline__ void pool_one(const Load& load, const Args& a, int row, int bin,
                                         const Window& w, bool live, float s, int c0, int nc,
                                         bool vec, T* out, int32_t* pos) {
  Acc<T, kPos, kChunked> r;
  r.init();
  int first = 0;
  constexpr int kU = kChunked ? kUnrollMap : kUnroll;
  if (live) first = scan_one<kChunked, kU>(load, a.W, w.h0, w.h1, w.w0, w.w1, w.ex, r);
  store_row<T, kPos>(a, row, bin, c0, nc, vec, live, s, answer_of(r, first), out, pos);
}

// The box and frame rows p and P + p of one bin over window w, the frame's
// rectangle w.ex: one scan.
template <typename T, bool kPos, bool kChunked, class Load>
__device__ __forceinline__ void pool_two(const Load& load, const Args& a, int p, int bin,
                                         const Window& w, float s, int c0, int nc, bool vec,
                                         T* out, int32_t* pos) {
  Acc<T, kPos, kChunked> frame, inner;
  frame.init();
  inner.init();
  constexpr int kU = kChunked ? kUnrollMap : kUnroll;
  const int first =
      scan_two<kChunked, kU>(load, a.W, w.h0, w.h1, w.w0, w.w1, w.ex, frame, inner);
  Answer<T, kPos> box = answer_of(inner, first);
  const Answer<T, kPos> fr = answer_of(frame, first);
  store_row<T, kPos>(a, a.P + p, bin, c0, nc, vec, true, s, fr, out, pos);
  merge<T, kPos>(box, fr);
  store_row<T, kPos>(a, p, bin, c0, nc, vec, true, s, box, out, pos);
}

// Zeros and -1 in a row's bin (an invalid ROI).
template <typename T, bool kPos>
__device__ __forceinline__ void blank_row(const Args& a, int row, int bin, int c0, int nc,
                                          bool vec, T* out, int32_t* pos) {
  Answer<T, kPos> r;
  r.best = make_uint4(0, 0, 0, 0);
  if constexpr (kPos) {
#pragma unroll
    for (int j = 0; j < Lane<T>::N; ++j) r.arg[j] = -1;
  }
  store_row<T, kPos>(a, row, bin, c0, nc, vec, false, 1.0f, r, out, pos);
}

// Work item (ctx, p, bin) of a valid ROI over window w: the context row
// 2P + p, or the box and frame rows p and P + p; the lane's channels c0 ..
// c0 + nc, the scale s. With kTiled, a window the tile holds is read from it
// (offsets from the window's first cell, which a staged window keeps below
// kSpan), any other from the map (offsets in chunks).
template <typename T, bool kPos, bool kTiled>
__device__ __forceinline__ void answer(const Args& a, const Tile& tile, const T* feat,
                                       bool ctx, int p, int bin, const Window& w, float s,
                                       int c0, int nc, bool vec, T* out, int32_t* pos) {
  const SharedCells shared{tile.cells + threadIdx.x % 32, tile.y0, tile.x0, tile.nx};
  const GlobalCells<T> global{feat + c0, a.C, nc, vec};
  const bool held = kTiled && tile.holds(w);
  if (ctx) {
    if (held) {
      pool_one<T, kPos, false>(shared, a, 2 * a.P + p, bin, w, true, s, c0, nc, vec, out, pos);
    } else {
      pool_one<T, kPos, true>(global, a, 2 * a.P + p, bin, w, true, s, c0, nc, vec, out, pos);
    }
  } else if (held) {
    pool_two<T, kPos, false>(shared, a, p, bin, w, s, c0, nc, vec, out, pos);
  } else {
    pool_two<T, kPos, true>(global, a, p, bin, w, s, c0, nc, vec, out, pos);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The cell a window's first corner is owned by: clamped into the map (an
// empty window may start at H or W).
__device__ __forceinline__ bool owns(int v, int limit, int lo) {
  const int c = min(v, limit - 1);
  return c >= lo && c < lo + kStride;
}

// The staged branch: block (tile t, channel group g) stages the region of
// kRegion x kRegion cells from (t / tiles_x, t % tiles_x) x kStride, 32
// lanes' 16-byte vectors of channels a cell, and answers every work item of
// a valid ROI whose window's first cell lies in its kStride x kStride cells.
// Block k of a tile's `split` takes every split-th batch of kGrab units. See
// the header for how its warps find their items.
template <typename T, bool kPos>
__global__ void __launch_bounds__(kTileThreads, 1)
tiled_kernel(const T* __restrict__ feat, Args a, int tiles_x, int groups, int split,
             T* __restrict__ out, int32_t* __restrict__ pos) {
  extern __shared__ uint4 cells[];
  __shared__ int next;
  constexpr int N = Lane<T>::N;
  const int g = blockIdx.x % groups, k = blockIdx.x / groups % split;
  const int tiles = gridDim.x / (groups * split);
  const int t = tiles - 1 - blockIdx.x / (groups * split);  // the heaviest tiles first
  const int y0 = t / tiles_x * kStride, x0 = t % tiles_x * kStride;
  const int ny = min(kRegion, a.H - y0), nx = min(kRegion, a.W - x0);
  const int lanes = min(32, a.C / N - g * 32);  // lanes with channels
  for (int i = threadIdx.x; i < ny * nx * lanes; i += kTileThreads) {
    const int c = i / lanes, l = i - c * lanes;
    const int y = y0 + c / nx, x = x0 + c % nx;
    cp_async16(&cells[c * kCellVecs + l], feat + ((int64_t)y * a.W + x) * a.C + (g * 32 + l) * N);
  }
  if (threadIdx.x == 0) next = 0;
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int c0 = (g * 32 + lane) * N;
  const bool has = lane < lanes;  // a lane without channels loads and stores nothing
  const Tile tile{cells, y0, x0, ny, nx};
  const int units = 3 * a.P, bins = a.PH * a.PW;
  for (;;) {
    int base = 0;
    if (lane == 0) base = (atomicAdd(&next, 1) * split + k) * kGrab;
    base = __shfl_sync(~0u, base, 0);
    if (base >= units) break;
    // the lane's unit: a ROI row below 2P, then a ROI to test for invalid
    const int j = lane < kGrab ? base + lane : units;
    bool hit = false, blank = false;
    if (j < 2 * a.P) {
      if (a.valid[j < a.P ? j : j - a.P] != 0) {
        const int wr = j < a.P ? j : a.P + j;  // p, or 2P + (j - P)
        int ya = a.H, yb = -1, xa = a.W, xb = -1;
        for (int i = 0; i < a.PH; ++i) {
          const int v = min(__ldg(a.hs + wr * a.PH + i), a.H - 1);
          ya = min(ya, v);
          yb = max(yb, v);
        }
        for (int i = 0; i < a.PW; ++i) {
          const int v = min(__ldg(a.ws + wr * a.PW + i), a.W - 1);
          xa = min(xa, v);
          xb = max(xb, v);
        }
        hit = yb >= y0 && ya < y0 + kStride && xb >= x0 && xa < x0 + kStride;
      }
    } else if (j < units) {
      blank = a.valid[j - 2 * a.P] == 0;
    }
    for (unsigned hits = __ballot_sync(~0u, hit); hits; hits &= hits - 1) {
      const int jj = base + __ffs(hits) - 1;
      const bool ctx = jj >= a.P;
      const int p = ctx ? jj - a.P : jj;
      const int wr = ctx ? 2 * a.P + p : p;  // its window row
      // the ROI row's windows, a lane a bin row (hs, he) and a bin column (ws, we)
      const int lr = min(lane, a.PH - 1), lc = min(lane, a.PW - 1);
      const int h0 = __ldg(a.hs + wr * a.PH + lr), h1 = __ldg(a.he + wr * a.PH + lr);
      const int v0 = __ldg(a.ws + wr * a.PW + lc), v1 = __ldg(a.we + wr * a.PW + lc);
      const int4 ex = rect(a, ctx ? wr : a.P + p);  // the context's or the frame's rectangle
      const float s = a.row_scale ? Lane<T>::round(a.row_scale[p]) : 1.0f;
      const unsigned rows_here = __ballot_sync(~0u, lane < a.PH && owns(h0, a.H, y0));
      const unsigned cols_here = __ballot_sync(~0u, lane < a.PW && owns(v0, a.W, x0));
      for (unsigned m = rows_here; m; m &= m - 1) {
        const int ph = __ffs(m) - 1;
        for (unsigned n = cols_here; n; n &= n - 1) {
          const int pw = __ffs(n) - 1;
          const Window win{__shfl_sync(~0u, h0, ph), __shfl_sync(~0u, h1, ph),
                           __shfl_sync(~0u, v0, pw), __shfl_sync(~0u, v1, pw), ex};
          answer<T, kPos, true>(a, tile, feat, ctx, p, ph * a.PW + pw, win, s, c0, has ? N : 0,
                                has, out, pos);
        }
      }
    }
    // An invalid ROI's bins, zeros and -1 in its three rows, are spread over
    // the tiles: bin b of ROI p goes to tile (p PH PW + b) mod tiles.
    for (unsigned blanks = __ballot_sync(~0u, blank); blanks; blanks &= blanks - 1) {
      const int p = base + __ffs(blanks) - 1 - 2 * a.P;
      const int64_t skew = ((int64_t)t - (int64_t)p * bins) % tiles;
      for (int bin = (int)(skew < 0 ? skew + tiles : skew); bin < bins; bin += tiles) {
        for (int row = p; row < 3 * a.P; row += a.P) {
          blank_row<T, kPos>(a, row, bin, c0, has ? N : 0, has, out, pos);
        }
      }
    }
  }
}

// The direct branch: a warp a work item, 32 16-byte channel vectors a warp
// (grid.y walks the channel ranges), the cells read from the map. Items:
// the box-and-frame items of every (ROI, bin), then the context items.
template <typename T, bool kPos>
__global__ void __launch_bounds__(kWarps * 32)
direct_kernel(const T* __restrict__ feat, Args a, bool vec, T* __restrict__ out,
              int32_t* __restrict__ pos) {
  constexpr int N = Lane<T>::N;
  const int item = blockIdx.x * kWarps + threadIdx.x / 32;
  const int c0 = (blockIdx.y * 32 + threadIdx.x % 32) * N;  // the lane's first channel
  const int bins = a.PH * a.PW, n = a.P * bins;
  if (item >= 2 * n || c0 >= a.C) return;
  const bool ctx = item >= n;
  const int it = ctx ? item - n : item;
  const int p = it / bins, bin = it - p * bins, ph = bin / a.PW, pw = bin % a.PW;
  const int nc = min(N, a.C - c0);
  if (a.valid[p] == 0) {
    blank_row<T, kPos>(a, ctx ? 2 * a.P + p : p, bin, c0, nc, vec, out, pos);
    if (!ctx) blank_row<T, kPos>(a, a.P + p, bin, c0, nc, vec, out, pos);
    return;
  }
  const float s = a.row_scale ? Lane<T>::round(a.row_scale[p]) : 1.0f;
  const Window win = window(a, ctx ? 2 * a.P + p : p, ph, pw, ctx ? 2 * a.P + p : a.P + p);
  answer<T, kPos, false>(a, Tile{}, feat, ctx, p, bin, win, s, c0, nc, vec, out, pos);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Plan {
  bool staged;
  int blocks, threads, smem;
  int tiles_x, groups, split, vec;
};

// The branch, grid and shared memory of a launch, from the shape, the type
// and the pointers' alignment alone: the staged branch where C fills whole
// 16-byte vectors, the pointers are 16-byte aligned, W <= kTiledMaxW and
// PH, PW <= 32 (a lane a bin row or column); else the direct branch.
template <typename T>
Plan plan(const void* feat, int H, int W, int C, const void* out, const void* pos, int P, int PH,
          int PW) {
  constexpr int N = Lane<T>::N;
  const bool vec = C % N == 0 && aligned16(feat) && aligned16(out) && (!pos || aligned16(pos));
  if (vec && W <= kTiledMaxW && PH <= 32 && PW <= 32) {
    const int tiles_x = (W + kStride - 1) / kStride, tiles_y = (H + kStride - 1) / kStride;
    const int groups = (C / N + 31) / 32;
    const int base = tiles_y * tiles_x * groups;
    const int split = (kMinBlocks + base - 1) / base;
    return Plan{true, base * split, kTileThreads, kRegion * kRegion * kCellVecs * 16, tiles_x,
                groups, split, 1};
  }
  const int64_t items = 2LL * P * PH * PW;
  return Plan{false, (int)((items + kWarps - 1) / kWarps), kWarps * 32, 0, 0,
              ((C + N - 1) / N + 31) / 32, 1, vec ? 1 : 0};
}

// What sos_roi_loop_pool_fwd returns after a launch without error.
constexpr int kStaged = -1, kDirect = -2;

template <typename T>
int launch(const void* feat, const Args& a, void* out, int32_t* pos, cudaStream_t stream) {
  const Plan pl = plan<T>(feat, a.H, a.W, a.C, out, pos, a.P, a.PH, a.PW);
  auto f = static_cast<const T*>(feat);
  auto o = static_cast<T*>(out);
  if (pl.staged) {
    auto kern = pos ? tiled_kernel<T, true> : tiled_kernel<T, false>;
    static bool configured[2] = {false, false};
    if (!configured[pos ? 1 : 0]) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
      if (e != cudaSuccess) return (int)e;
      configured[pos ? 1 : 0] = true;
    }
    kern<<<pl.blocks, pl.threads, pl.smem, stream>>>(f, a, pl.tiles_x, pl.groups, pl.split, o,
                                                      pos);
  } else {
    auto kern = pos ? direct_kernel<T, true> : direct_kernel<T, false>;
    kern<<<dim3(pl.blocks, pl.groups), pl.threads, 0, stream>>>(f, a, pl.vec != 0, o, pos);
  }
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : pl.staged ? kStaged : kDirect;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hs/he (3P, PH), ws/we (3P, PW) and ex
// (3P, 4) are int32, the frame rows' windows equal to the box rows' and the
// box rows' rectangles excluding nothing (not read); valid (P,) bool bytes;
// row_scale (P,) f32 or null; out (3P, PH, PW, C) and pos (same, int32, or
// null). Returns cudaGetLastError() after the launch where it is an error
// (> 0), else the branch launched: -1 staged, -2 direct; P == 0 or C == 0
// launches nothing and returns 0.
extern "C" int sos_roi_loop_pool_fwd(int dtype, const void* feat, int H, int W, int C,
                                     const void* hs, const void* he, const void* ws,
                                     const void* we, const void* ex, const void* valid,
                                     const void* row_scale, int P, int PH, int PW, void* out,
                                     void* pos, void* stream) {
  if (P == 0 || C == 0) return 0;
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const Args a{H, W, C, P, PH, PW, i32(hs), i32(he), i32(ws), i32(we), i32(ex),
               static_cast<const uint8_t*>(valid), static_cast<const float*>(row_scale)};
  auto st = static_cast<cudaStream_t>(stream);
  auto pos32 = static_cast<int32_t*>(pos);
  if (dtype == 0) return launch<float>(feat, a, out, pos32, st);
  if (dtype == 1) return launch<__nv_bfloat16>(feat, a, out, pos32, st);
  return (int)cudaErrorInvalidValue;
}
