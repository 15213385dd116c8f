// Group-tiled popcount cross-matrices for Hopper (sm_90a): the k = kmax
// count over a level's within-group candidate pairs, one block pair of rows
// at a time.
//
// For each block pair s with block indices (i, j) = (tile_i[s], tile_j[s])
// into the (t, W) bitsets cut in blocks of bm rows:
//   out[s, a, b] = popcount(bits[i*bm + a] & bits[j*bm + b])   (0 <= a, b < bm)
// summed over all W words, int32. A block index outside [0, t / bm) gives a
// zero matrix. Replaces the Pallas TPU kernel intersect_count_tiled
// (src/repro/kernels/intersect/tiled.py:57).
//
// Design. The Pallas grid is (T, W / bw): it zeroes a pair's (bm, bm)
// output tile on its first word block and adds one block's cross-matrix per
// step, relying on the TPU's in-order grid. CUDA blocks run in no order, so
// here one CTA owns all W words of one block pair (of one 8 x 8 sub-block
// of it), and the cross-matrix is a binary tensor-core product:
//   mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc
// computes D = A . B^T + C over 128 bits, with the AND of each bit pair
// and a popcount in place of multiply and add. A is the 8 rows of block i
// and B the 8 rows of block j over the same 128 bits, so D[a][b] is the
// popcount of (row a & row b) there: an 8 x 8 tile is exactly the m8n8
// shape. Lane (g, c) = (lane / 4, lane % 4) holds 32 bits of row g of A
// and of B, and D[g][2c], D[g][2c + 1] (PTX ISA, the m8n8k128 .b1
// fragment layouts).
// * The 8 warps of a CTA take 16-word chunks of the word axis in turn.
//   Where W is a multiple of 4 (and the rows 16-byte aligned), lane (g, c)
//   loads words 4c..4c+3 of a chunk of row g as one uint4 and feeds .x, .y,
//   .z and .w to four successive mmas: the sum over bits commutes, so A and
//   B may take their bits in any order as long as it is the same one. A
//   chunk past W (the tail, where W % 16 != 0) loads zero words. Otherwise
//   a 32-bit path takes 4-word chunks, one word a lane, zero past W.
// * Rows past bm (bm < 8, or the ragged sub-block of bm > 8) load zero and
//   are not stored; bm > 8 takes its 8 x 8 sub-blocks on gridDim.y. A
//   diagonal sub-block (i == j, same rows) loads its rows once for A and B.
// * At the end the warps' D fragments (two int32 a lane) are summed in
//   shared memory and stored. The lower triangle and diagonal of a diagonal
//   tile, and zero padding rows, are computed as on the TPU: the output is
//   defined for them.
//
// Bound. At the Poker-hand 1M level-3 frontier (T = 25,100, bm = 8,
// W = 31,252) the input read once is 9.69 GB, ~2.9 ms at 3.35 TB/s, and
// that bounds the function. An AND and two carry-save (Harley-Seal) logic
// operations per entry and word would take ~9 ms at the card's 64 logic
// operations per clock per SM, and one __popc per entry and word (this
// kernel's first design) ~12 ms at 16 per clock per SM; the b1 product
// does the same 1.6e12 bit products in ~0.8 ms at the m8n8k128 rate the
// smoke measures. What is left is the traffic: the kernel requests 8 rows
// of each of the two blocks of a tile (~40 GB there) and leaves the reuse
// of a group's blocks across its tiles to the L2 cache.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;  // edge of the m8n8 tile

__device__ __forceinline__ void mma_and_popc(int32_t (&d)[2], uint32_t a, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+r"(d[0]), "+r"(d[1])
      : "r"(a), "r"(b));
}

// One CTA: block pair blockIdx.x, sub-block blockIdx.y, all W words. Rows
// a >= na and b >= nb of the sub-block are outside the tile: they load zero
// and are not stored.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const uint32_t* __restrict__ bits, long long n_blocks, long long W, int bm,
             const int32_t* __restrict__ tile_i, const int32_t* __restrict__ tile_j,
             int n_sub, int32_t* __restrict__ out) {
  const long long s = blockIdx.x;
  const int a0 = static_cast<int>(blockIdx.y) / n_sub * kSub;
  const int b0 = static_cast<int>(blockIdx.y) % n_sub * kSub;
  const int na = min(kSub, bm - a0);
  const int nb = min(kSub, bm - b0);
  const long long bi = tile_i[s];
  const long long bj = tile_j[s];
  const bool in_range = bi >= 0 && bi < n_blocks && bj >= 0 && bj < n_blocks;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;  // the row of A and of B this lane loads
  const int c = lane % 4;  // its word of each 4 (128 bits)
  const bool load_a = in_range && g < na;
  const bool load_b = in_range && g < nb;
  const bool same = bi == bj && a0 == b0;  // A and B are the same rows
  const long long row_a = load_a ? bi * bm + a0 + g : 0;
  const long long row_b = load_b ? bj * bm + b0 + g : 0;

  int32_t d[2] = {0, 0};
  if constexpr (VEC) {
    const long long ru = W / 4;  // row length in uint4
    const uint4* pa = reinterpret_cast<const uint4*>(bits) + row_a * ru;
    const uint4* pb = reinterpret_cast<const uint4*>(bits) + row_b * ru;
    const long long chunks = (ru + 3) / 4;  // 16 words each
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (long long q = warp; q < chunks; q += kWarps) {
      const long long u = q * 4 + c;
      const bool in_w = u < ru;
      const uint4 x = load_a && in_w ? __ldg(pa + u) : zero;
      const uint4 y = same ? x : load_b && in_w ? __ldg(pb + u) : zero;
      mma_and_popc(d, x.x, y.x);
      mma_and_popc(d, x.y, y.y);
      mma_and_popc(d, x.z, y.z);
      mma_and_popc(d, x.w, y.w);
    }
  } else {
    const uint32_t* pa = bits + row_a * W;
    const uint32_t* pb = bits + row_b * W;
    const long long chunks = (W + 3) / 4;  // 4 words each
#pragma unroll 4
    for (long long q = warp; q < chunks; q += kWarps) {
      const long long w = q * 4 + c;
      const bool in_w = w < W;
      const uint32_t x = load_a && in_w ? __ldg(pa + w) : 0u;
      const uint32_t y = same ? x : load_b && in_w ? __ldg(pb + w) : 0u;
      mma_and_popc(d, x, y);
    }
  }

  // D[g][2c + e] of every warp, summed in shared memory
  __shared__ int32_t partial[kWarps][kSub * kSub];
  partial[warp][g * kSub + 2 * c] = d[0];
  partial[warp][g * kSub + 2 * c + 1] = d[1];
  __syncthreads();
  if (threadIdx.x < kSub * kSub) {
    const int a = threadIdx.x / kSub;
    const int b = threadIdx.x % kSub;
    if (a < na && b < nb) {
      int32_t v = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) v += partial[k][threadIdx.x];
      out[(s * bm + a0 + a) * bm + b0 + b] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launch the kernel on `stream`; returns the first CUDA error (0 = the
// launch was accepted). bits (t, W) uint32 words, tile_i / tile_j (T,)
// int32 block indices, out (T, bm, bm) int32, all contiguous on the current
// device. T >= 1, W >= 1, bm >= 1 and ceil(bm / 8)^2 <= 65535: the caller
// checks. vec4 = 1 only where W % 4 == 0 and bits is 16-byte aligned.
int tiled_count(const void* bits, long long t, long long W, int bm, const void* tile_i,
                const void* tile_j, long long T, int vec4, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_sub = (bm + kSub - 1) / kSub;
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* ti = static_cast<const int32_t*>(tile_i);
  const auto* tj = static_cast<const int32_t*>(tile_j);
  auto* o = static_cast<int32_t*>(out);
  const long long n_blocks = t / bm;
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(n_sub * n_sub));
  if (vec4) {
    tiled_kernel<true><<<grid, kThreads, 0, s>>>(b, n_blocks, W, bm, ti, tj, n_sub, o);
  } else {
    tiled_kernel<false><<<grid, kThreads, 0, s>>>(b, n_blocks, W, bm, ti, tj, n_sub, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
