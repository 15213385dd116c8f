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
// here one CTA owns all W words of one block pair and loops over them:
// * 256 threads stride the word axis; for each word (four words with
//   128-bit loads, where W is a multiple of 4 on 16-byte-aligned storage) a
//   thread loads the R words of row block i and the R of row block j, both
//   coalesced across the warp, and adds the R x R popcounts of their ANDs
//   to counters in registers (64 at bm = 8);
// * the register tile is at most 8 x 8 (R in {1, 2, 4, 8}, the least that
//   covers min(bm, 8)); for bm > 8, gridDim.y indexes the 8 x 8 sub-blocks
//   of a tile, and the rows past bm of a ragged sub-block load nothing and
//   are not stored;
// * at the end each counter is summed across the warp with shuffles and
//   across warps in shared memory, then stored.
// The lower triangle and diagonal of a diagonal tile, and zero padding
// rows, are computed as on the TPU: the output is defined for them.
//
// Bound. At the Poker-hand 1M level-3 frontier (T = 25,100, bm = 8,
// W = 31,252) the input read once is 9.69 GB, ~2.9 ms at 3.35 TB/s, and
// that bounds the function: its AND per (entry, word) and a carry-save
// (Harley-Seal) sum of the ANDs take ~2.2 ms at the 32-bit rate and leave
// one popcount per 16 words. This simple kernel does one __popc per
// (entry, word) instead, 5.0e10 there; Hopper issues 16 32-bit population
// counts per clock per SM (CUDA C++ Programming Guide, arithmetic
// instruction throughput, compute capability 9.0), ~4.2e12/s on 132 SMs at
// 1,980 MHz, so the kernel cannot pass ~12 ms. It also reads 2 bm W words
// per tile (~40 GB there) and leaves reuse of a group's blocks to the L2
// cache. A carry-save sum, or the binary tensor-core product
// (mma.sync ... .b1 ... .and.popc, since sm_80), would lift the popcount
// limit; that is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;  // edge of the register tile

template <int R>
__device__ __forceinline__ void add_cross(int (&acc)[R][R], const uint32_t (&x)[R],
                                          const uint32_t (&y)[R]) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] += __popc(x[a] & y[b]);
  }
}

// One CTA: block pair blockIdx.x, sub-block blockIdx.y, all W words. Rows
// a >= na and b >= nb of the sub-block are outside the tile: they load zero
// and are not stored.
template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const uint32_t* __restrict__ bits, long long n_blocks, long long W, int bm,
             const int32_t* __restrict__ tile_i, const int32_t* __restrict__ tile_j,
             int n_sub, int32_t* __restrict__ out) {
  const long long s = blockIdx.x;
  const int a0 = static_cast<int>(blockIdx.y) / n_sub * kSub;
  const int b0 = static_cast<int>(blockIdx.y) % n_sub * kSub;
  const int na = min(R, bm - a0);
  const int nb = min(R, bm - b0);
  const long long bi = tile_i[s];
  const long long bj = tile_j[s];
  const bool in_range = bi >= 0 && bi < n_blocks && bj >= 0 && bj < n_blocks;

  const long long units = in_range ? (VEC ? W / 4 : W) : 0;  // a zero tile: no loads
  const long long row_a = in_range ? bi * bm + a0 : 0;
  const long long row_b = in_range ? bj * bm + b0 : 0;

  int acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0;
  }

  if constexpr (VEC) {
    const uint4* base = reinterpret_cast<const uint4*>(bits);
    const long long ru = W / 4;  // row stride in uint4
    const uint4* pa = base + row_a * ru;
    const uint4* pb = base + row_b * ru;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long u = threadIdx.x; u < units; u += kThreads) {
      uint4 x[R], y[R];
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = a < na ? __ldg(pa + a * ru + u) : zero;
#pragma unroll
      for (int b = 0; b < R; ++b) y[b] = b < nb ? __ldg(pb + b * ru + u) : zero;
      uint32_t xs[R], ys[R];
#pragma unroll
      for (int a = 0; a < R; ++a) xs[a] = x[a].x;
#pragma unroll
      for (int b = 0; b < R; ++b) ys[b] = y[b].x;
      add_cross<R>(acc, xs, ys);
#pragma unroll
      for (int a = 0; a < R; ++a) xs[a] = x[a].y;
#pragma unroll
      for (int b = 0; b < R; ++b) ys[b] = y[b].y;
      add_cross<R>(acc, xs, ys);
#pragma unroll
      for (int a = 0; a < R; ++a) xs[a] = x[a].z;
#pragma unroll
      for (int b = 0; b < R; ++b) ys[b] = y[b].z;
      add_cross<R>(acc, xs, ys);
#pragma unroll
      for (int a = 0; a < R; ++a) xs[a] = x[a].w;
#pragma unroll
      for (int b = 0; b < R; ++b) ys[b] = y[b].w;
      add_cross<R>(acc, xs, ys);
    }
  } else {
    const uint32_t* pa = bits + row_a * W;
    const uint32_t* pb = bits + row_b * W;
    for (long long u = threadIdx.x; u < units; u += kThreads) {
      uint32_t x[R], y[R];
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = a < na ? __ldg(pa + a * W + u) : 0u;
#pragma unroll
      for (int b = 0; b < R; ++b) y[b] = b < nb ? __ldg(pb + b * W + u) : 0u;
      add_cross<R>(acc, x, y);
    }
  }

  // warp shuffles, then one shared-memory step across the warps
  __shared__ int partial[kWarps][R * R];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) {
      int v = acc[a][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partial[warp][a * R + b] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * R; e += kThreads) {
    const int a = e / R;
    const int b = e % R;
    if (a >= na || b >= nb) continue;
    int v = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += partial[k][e];
    out[(s * bm + a0 + a) * bm + b0 + b] = v;
  }
}

template <int R>
void launch(const uint32_t* bits, long long n_blocks, long long W, int bm, const int32_t* ti,
            const int32_t* tj, long long T, int n_sub, bool vec4, int32_t* out, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(n_sub * n_sub));
  if (vec4) {
    tiled_kernel<R, true><<<grid, kThreads, 0, s>>>(bits, n_blocks, W, bm, ti, tj, n_sub, out);
  } else {
    tiled_kernel<R, false><<<grid, kThreads, 0, s>>>(bits, n_blocks, W, bm, ti, tj, n_sub, out);
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
  const int r = bm > 4 ? 8 : bm > 2 ? 4 : bm;  // 1, 2, 4 or 8: covers min(bm, 8)
  const auto* b = static_cast<const uint32_t*>(bits);
  const auto* ti = static_cast<const int32_t*>(tile_i);
  const auto* tj = static_cast<const int32_t*>(tile_j);
  auto* o = static_cast<int32_t*>(out);
  const long long n_blocks = t / bm;
  switch (r) {
    case 1: launch<1>(b, n_blocks, W, bm, ti, tj, T, n_sub, vec4, o, s); break;
    case 2: launch<2>(b, n_blocks, W, bm, ti, tj, T, n_sub, vec4, o, s); break;
    case 4: launch<4>(b, n_blocks, W, bm, ti, tj, T, n_sub, vec4, o, s); break;
    default: launch<8>(b, n_blocks, W, bm, ti, tj, T, n_sub, vec4, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
