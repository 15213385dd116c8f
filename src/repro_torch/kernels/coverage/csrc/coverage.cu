// Record coverage for Hopper (sm_90a): the privacy path's accumulator.
//
// For a batch of M itemsets sets[m] = (i_0, ..., i_{K-1}) over the (t, W)
// item bitsets, with int32 weights[m]:
//   acc[b, w] = sum_m weights[m] * bit b of (bits[i_0] & ... & bits[i_{K-1}])[w]
// the per-record coverage count in word-major layout (record r = bit r % 32
// of word r / 32), int32 with wraparound. Replaces the Pallas TPU kernel
// coverage_accumulate_indexed (src/repro/kernels/coverage/coverage.py:72).
//
// Design. The Pallas kernel walks a (word block, set) grid in order: it
// zeroes its output tile on a block's first set and adds one set per grid
// step, relying on the TPU's in-order grid. CUDA blocks run in no order, so
// here:
// * a thread owns one word w (coalesced loads of each set's rows) and keeps
//   its 32 bit-plane sums in registers;
// * grid.x covers the words, grid.y splits the set axis into chunks, so the
//   card gets enough CTAs even where W is small (W = 3,128 is 13 word
//   blocks); chunk c takes sets c, c + grid.y, c + 2 grid.y, ..., which
//   spreads the batch's weight-0 padding rows (at its end) over every chunk;
// * each CTA stages its chunk's set indices and weights in shared memory,
//   a tile at a time, and its threads read them as broadcasts;
// * at the end every thread adds its nonzero sums into the output with
//   atomicAdd. The output is zeroed on the stream first. Unsigned addition
//   wraps and is associative and commutative, so the result is the same
//   bits in any order of the chunks: no second pass, and no dependence on
//   the order in which CTAs run.
// Exact shortcuts: a weight-0 set is skipped, and a word's AND stops at the
// first item that makes it 0 (a QI covers <= tau records, so almost every
// word of a mined QI's AND is 0). K is a runtime loop; sets longer than a
// shared-memory tile read their indices from device memory instead.
//
// Bound. Sparse batches (mined QIs) re-read the same frequent item rows, so
// they run from L2; the bytes that must move are the distinct rows read
// once plus the 32 x W output, and the operations 2K per (set, word) plus
// 3 per set bit of the ANDs. This scan does M * W loads whatever the data,
// so on a batch of mined QIs, whose ANDs are almost all zero, it reaches ~1%
// of that bound; and it spends 32 bit-plane adds on every nonzero AND
// (~96 operations) where a random one has ~4 set bits, so a dense batch
// reaches under a tenth of it.
//
// The anchored kernel (coverage_anchored_kernel, below) computes the same
// accumulator from a per-item index of nonzero words (offsets (t + 1,)
// int64, words (nnz,) int32, ascending per item). A set's AND is zero
// wherever its rarest member's word is, so each set walks only the nonzero
// words of its anchor, the member with the fewest (the first on ties):
// * one warp per set, grid-striding over the sets, skipping weight-0 sets;
//   its lanes stride the anchor's word list. A list can be up to W words
//   long, so gridDim.y cuts every list into that many slices (a multiple of
//   32 words each), sized by the caller from the longest anchor in the
//   batch: no warp walks a long list while the others idle;
// * per word, the members' words are ANDed, stopping at the first zero;
// * each set bit b of the AND adds the weight at acc[b, w] with atomicAdd,
//   into the output zeroed on the stream: wrapping unsigned addition
//   commutes, so every order gives the reference's int32 bits.
// Its work is 2K loads and ANDs per (set, anchor word) and three
// operations and one atomic per set bit, far below the scan's on a sparse
// batch; launch and the output's memset bound it there. On a dense batch
// (random rows, or anchors with about as many nonzero words as W) every
// word has ~16 set bits and the atomics cost more than the scan's 32
// register sums, so the dispatch keeps the scan for a batch whose anchors
// have more than W / 8 nonzero words per live set on average (the host
// engine's rule).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileInts = 2048;  // staged set indices (and weights) per tile
constexpr int kCtasPerSm = 4;    // the grid aims at this many CTAs per SM

__global__ void __launch_bounds__(kThreads)
coverage_kernel(const uint32_t* __restrict__ bits, int64_t t, int64_t W,
                const int32_t* __restrict__ sets, const int32_t* __restrict__ weights,
                int64_t M, int K, uint32_t* __restrict__ acc_out) {
  __shared__ int32_t s_sets[kTileInts];
  __shared__ int32_t s_wt[kTileInts];
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = w < W;
  const int64_t chunk = blockIdx.y;
  const int64_t stride = gridDim.y;
  const int64_t n_local = chunk < M ? (M - chunk + stride - 1) / stride : 0;
  const bool staged = K <= kTileInts;
  const int tile = staged ? kTileInts / K : kTileInts;

  uint32_t acc[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) acc[b] = 0u;

  for (int64_t l0 = 0; l0 < n_local; l0 += tile) {
    const int n = static_cast<int>(n_local - l0 < tile ? n_local - l0 : tile);
    __syncthreads();  // every thread is done with the previous tile
    if (staged) {
      for (int i = threadIdx.x; i < n * K; i += kThreads) {
        const int j = i / K;
        const int32_t item = sets[(chunk + (l0 + j) * stride) * K + (i - j * K)];
        if (item < 0 || item >= t) __trap();  // a bad index is a caller bug
        s_sets[i] = item;
      }
    }
    for (int j = threadIdx.x; j < n; j += kThreads) s_wt[j] = weights[chunk + (l0 + j) * stride];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const uint32_t wt = static_cast<uint32_t>(s_wt[j]);
      if (wt == 0u) continue;
      const int32_t* idx = staged ? s_sets + j * K : sets + (chunk + (l0 + j) * stride) * K;
      uint32_t x = ~0u;
      for (int k = 0; k < K && x != 0u; ++k) {
        const int64_t item = idx[k];
        if (!staged && (item < 0 || item >= t)) __trap();
        x &= __ldg(bits + item * W + w);
      }
      if (x != 0u) {
#pragma unroll
        for (int b = 0; b < 32; ++b) acc[b] += ((x >> b) & 1u) * wt;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (acc[b] != 0u) atomicAdd(acc_out + b * W + w, acc[b]);
    }
  }
}

constexpr int kAnchorWarps = 8;      // warps per CTA of the anchored kernel
constexpr int kSliceWords = 256;     // anchor words a warp walks, at most, per slice
constexpr int kMaxCtasPerSm = 8;

__global__ void __launch_bounds__(kAnchorWarps * 32)
coverage_anchored_kernel(const uint32_t* __restrict__ bits, int64_t t, int64_t W,
                         const int64_t* __restrict__ offsets, const int32_t* __restrict__ words,
                         const int32_t* __restrict__ sets, const int32_t* __restrict__ weights,
                         int64_t M, int K, uint32_t* __restrict__ acc_out) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kAnchorWarps;
  const int64_t slice = blockIdx.y;
  const int64_t n_slices = gridDim.y;
  for (int64_t m = static_cast<int64_t>(blockIdx.x) * kAnchorWarps + threadIdx.x / 32; m < M;
       m += warps) {
    const uint32_t wt = static_cast<uint32_t>(__ldg(weights + m));
    if (wt == 0u) continue;  // warp-uniform
    const int32_t* idx = sets + m * K;
    int64_t anchor = -1, lo = 0, n = 0;
    for (int k = 0; k < K; ++k) {
      const int64_t item = __ldg(idx + k);
      if (item < 0 || item >= t) __trap();  // a bad index is a caller bug
      const int64_t begin = __ldg(offsets + item);
      const int64_t count = __ldg(offsets + item + 1) - begin;
      if (anchor < 0 || count < n) {
        anchor = item;
        lo = begin;
        n = count;
      }
    }
    // this warp's slice of the anchor's list, a multiple of 32 words long
    const int64_t per = ((n + n_slices - 1) / n_slices + 31) / 32 * 32;
    const int64_t end = min(n, (slice + 1) * per);
    for (int64_t i = slice * per + lane; i < end; i += 32) {
      const int64_t w = __ldg(words + lo + i);
      uint32_t x = __ldg(bits + anchor * W + w);
      for (int k = 0; k < K && x != 0u; ++k) {
        const int64_t item = __ldg(idx + k);
        if (item != anchor) x &= __ldg(bits + item * W + w);
      }
      while (x != 0u) {
        const int b = __ffs(x) - 1;
        atomicAdd(acc_out + b * W + w, wt);
        x &= x - 1u;
      }
    }
  }
}

}  // namespace

extern "C" {

// Zero acc (32, W) and launch the kernel on `stream`; returns the first CUDA
// error (0 = accepted). bits (t, W) uint32 words, sets (M, K) int32,
// weights (M,) int32, all contiguous on the current device. M >= 1, K >= 1:
// the caller skips empty batches.
int coverage_accumulate(const void* bits, long long t, long long W, const void* sets,
                        long long M, int K, const void* weights, void* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(32) * W * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks_x = (W + kThreads - 1) / kThreads;
  const long long target = static_cast<long long>(kCtasPerSm) * sms;
  long long chunks = (target + blocks_x - 1) / blocks_x;
  chunks = chunks < 1 ? 1 : chunks;
  chunks = chunks > M ? M : chunks;
  chunks = chunks > 65535 ? 65535 : chunks;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(chunks));
  coverage_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(bits), t, W, static_cast<const int32_t*>(sets),
      static_cast<const int32_t*>(weights), M, K, static_cast<uint32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// Zero acc (32, W) and launch the anchored kernel on `stream`; returns the
// first CUDA error (0 = accepted). bits (t, W) uint32 words, offsets (t + 1,)
// int64 and words (nnz,) int32 its index of nonzero words, sets (M, K)
// int32, weights (M,) int32, all contiguous on the current device. M >= 1,
// K >= 1: the caller skips empty batches. max_anchor_words (the most
// nonzero words of a live set's anchor) sizes the slices; any value gives
// the same result.
int coverage_anchored(const void* bits, long long t, long long W, const void* offsets,
                      const void* words, const void* sets, long long M, int K, const void* weights,
                      void* acc, long long max_anchor_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, static_cast<size_t>(32) * W * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long slices = (max_anchor_words + kSliceWords - 1) / kSliceWords;
  slices = slices < 1 ? 1 : slices > 65535 ? 65535 : slices;
  // a warp per set, up to one full wave of CTAs over all the slices
  long long blocks = (M + kAnchorWarps - 1) / kAnchorWarps;
  const long long wave = (static_cast<long long>(kMaxCtasPerSm) * sms + slices - 1) / slices;
  blocks = blocks > wave ? wave : blocks;
  blocks = blocks < 1 ? 1 : blocks;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  coverage_anchored_kernel<<<grid, kAnchorWarps * 32, 0, s>>>(
      static_cast<const uint32_t*>(bits), t, W, static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(sets),
      static_cast<const int32_t*>(weights), M, K, static_cast<uint32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

const char* coverage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
