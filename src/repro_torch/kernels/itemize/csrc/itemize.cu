// Item table of an integer table for Hopper (sm_90a): the cold mine's entry
// layer (paper Definitions 3.1-3.5).
//
// For an (n, m) int64 table, row-major, every item (value, column) gets an
// id, column-major with values ascending (np.unique's order per column), and
//   bits[id, w]  = the rows 32w .. 32w + 31 holding the item, bit r % 32
//   freq[id]     = |R_a|
//   min_row[id]  = min R_a
// Replaces no Pallas kernel: the reference builds the table on the host with
// numpy (src/repro/core/items.py, itemize), as the port's host path
// (core/items.py, _itemize) does for every placement but a single device.
// The wrapper (ops.py) finds each column's min and max, and the column's
// item ids come from one of two routes:
// * dense (value range at most n): itemize_presence marks the values
//   present in a per-column slot table; an exclusive scan of it (torch)
//   gives each present value its id within the column;
// * sorted (any wider column): torch's sort of the column ranks its values,
//   and each cell's id within the column is kept in an int64 row.
// Per-column parameters, (m, 5) int64: lo (the column's min), off (its
// first slot in the dense table; the table's end for a sorted column), span
// (its number of slots; 0 when sorted), srow (its row of sorted ids; -1 when
// dense) and base (the id of its first item).
//
// Design. itemize_bits gives a block one 32-row word w and its warps the
// columns: a warp reads one column of those 32 rows (the block's rows are one
// contiguous stretch of the table, so the warps' strided reads hit L1), each
// lane maps its value to its item id, and __match_any_sync groups the lanes
// by id: the group's mask is the item's word, and its lowest lane stores it.
// Each (item, word) is stored once, with no atomics; the memset before gives
// every other word its zero. Lanes at or past n take no id, so padding bits
// stay 0. itemize_stats then reads each item's row of words: freq is their
// popcount, min_row 32 w + ctz of the first nonzero word. A block reduces a
// stretch of one row with shuffles and shared memory before its one atomicAdd
// and atomicMin: integer sums and minima give the same bits in any order.
//
// Bound. Device memory: the table read once (8 n m bytes) and the bits
// written once (4 n_items W) take 27.7 us at 3.35 TB/s for the 1,025,010 x 10
// Poker-hand table (85 items) and 7.3 us for Connect-4's 67,557 x 43 (124
// items). The presence pass reads the table a second time and the stats
// kernel the bits; neither is needed by the function, and both are far
// under the table's upload from the host (the wrapper's, ~5 ms and ~2.4 ms).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
constexpr long long kStatsWords = 8192;  // words of one row a stats block reduces
constexpr int kLo = 0, kOff = 1, kSrow = 3, kBase = 4, kParams = 5;  // column 2: span

__global__ void __launch_bounds__(kThreads)
presence_kernel(const int64_t* __restrict__ table, long long cells, long long m,
                const int64_t* __restrict__ params, uint8_t* present) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    const int64_t* p = params + (i % m) * kParams;
    if (p[kSrow] < 0) {
      // the value's distance from the column's min, < span <= n: exact in
      // unsigned arithmetic whatever the two int64 values are
      const uint64_t d = static_cast<uint64_t>(table[i]) - static_cast<uint64_t>(p[kLo]);
      // most cells repeat a value already marked: a read, not a store to a
      // byte that every thread of the card would otherwise queue on
      uint8_t* slot = present + p[kOff] + static_cast<long long>(d);
      if (*slot == 0) *slot = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bits_kernel(const int64_t* __restrict__ table, long long n, long long m, long long W,
            const int64_t* __restrict__ params, const int64_t* __restrict__ ex,
            const int64_t* __restrict__ sorted_ids, uint32_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (long long w = blockIdx.x; w < W; w += gridDim.x) {
    const long long r = w * 32 + lane;
    const bool live = r < n;
    for (long long j = warp; j < m; j += warps) {
      const int64_t* p = params + j * kParams;
      long long id = -1;
      if (live) {
        const long long srow = p[kSrow];
        if (srow < 0) {
          const long long off = p[kOff];
          const uint64_t d = static_cast<uint64_t>(table[r * m + j]) - static_cast<uint64_t>(p[kLo]);
          id = p[kBase] + ex[off + static_cast<long long>(d)] - ex[off];
        } else {
          id = p[kBase] + sorted_ids[srow * n + r];
        }
      }
      const unsigned group = __match_any_sync(0xffffffffu, static_cast<unsigned long long>(id));
      if (live && lane == __ffs(group) - 1) bits[id * W + w] = group;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const uint32_t* __restrict__ bits, long long W, long long chunk,
             unsigned long long* __restrict__ freq, unsigned long long* __restrict__ min_row) {
  __shared__ unsigned long long s_cnt[kMaxWarps];
  __shared__ unsigned long long s_first[kMaxWarps];
  const long long item = blockIdx.x;
  const long long w0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long w1 = w0 + chunk < W ? w0 + chunk : W;
  const uint32_t* row = bits + item * W;
  unsigned long long cnt = 0;
  unsigned long long first = ~0ull;
  for (long long w = w0 + threadIdx.x; w < w1; w += blockDim.x) {
    const uint32_t x = row[w];
    if (x != 0) {
      cnt += __popc(x);
      const unsigned long long bit = static_cast<unsigned long long>(w) * 32 + (__ffs(x) - 1);
      first = bit < first ? bit : first;
    }
  }
  for (int s = 16; s > 0; s >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, s);
    const unsigned long long o = __shfl_down_sync(0xffffffffu, first, s);
    first = o < first ? o : first;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_first[warp] = first;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k) {
      cnt += s_cnt[k];
      first = s_first[k] < first ? s_first[k] : first;
    }
    if (cnt != 0) {
      atomicAdd(freq + item, cnt);
      atomicMin(min_row + item, first);
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Zero present (slots,) uint8 and mark, for every cell of a dense column,
// the slot of its value; launched on `stream`, returns the first CUDA error
// (0 = accepted). table (n, m) int64 and params (m, 5) int64, contiguous on
// the current device; n, m, slots >= 1.
int itemize_presence(const void* table, long long n, long long m, const void* params,
                     void* present, long long slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(present, 0, static_cast<size_t>(slots), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const long long cells = n * m;
  long long blocks = (cells + kThreads - 1) / kThreads;
  const long long wave = 16LL * sms;
  blocks = blocks > wave ? wave : blocks;
  presence_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int64_t*>(table), cells, m, static_cast<const int64_t*>(params),
      static_cast<uint8_t*>(present));
  return static_cast<int>(cudaGetLastError());
}

// Zero bits (n_items, W) uint32 and freq (n_items,), set min_row (n_items,)
// to all ones, then launch the bitset kernel and the stats kernel on
// `stream`; returns the first CUDA error (0 = accepted). ex (slots + 1,)
// int64 is the exclusive scan of the slot table, sorted_ids (sorted
// columns, n) int64 the sorted columns' ids within their column (unread
// when no column is sorted). All contiguous on the current device; n, m,
// n_items >= 1.
int itemize_bits(const void* table, long long n, long long m, long long W, const void* params,
                 const void* ex, const void* sorted_ids, void* bits, long long n_items, void* freq,
                 void* min_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nb = static_cast<size_t>(n_items);
  cudaError_t err = cudaMemsetAsync(bits, 0, nb * static_cast<size_t>(W) * sizeof(uint32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(freq, 0, nb * sizeof(int64_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(min_row, 0xFF, nb * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = m < kMaxWarps ? m : kMaxWarps;
  const long long blocks = W < (1LL << 30) ? W : (1LL << 30);
  bits_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(32 * warps), 0, s>>>(
      static_cast<const int64_t*>(table), n, m, W, static_cast<const int64_t*>(params),
      static_cast<const int64_t*>(ex), static_cast<const int64_t*>(sorted_ids),
      static_cast<uint32_t*>(bits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long chunk = (W + 65534) / 65535;
  chunk = chunk < kStatsWords ? kStatsWords : chunk;
  const dim3 grid(static_cast<unsigned>(n_items), static_cast<unsigned>((W + chunk - 1) / chunk));
  stats_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(bits), W, chunk,
                                         static_cast<unsigned long long*>(freq),
                                         static_cast<unsigned long long*>(min_row));
  return static_cast<int>(cudaGetLastError());
}

const char* itemize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
