// Indexed bitset intersection for Hopper (sm_90a): the paper's bottleneck,
// Alg. 1 line 31, with the classification of lines 32-41 fused in.
//
// For each pair m with rows (i, j) = pairs[m] of the (t, W) parent bitsets:
//   child[m] = bits[i] & bits[j]                     (WRITE)
//   cnt[m]   = popcount(child[m])
//   cls[m]   = SKIP  if cnt == 0 or cnt == min(pc[i], pc[j])   (CLASSIFY)
//              EMIT  if cnt <= tau
//              STORE otherwise
//
// One template, four instantiations, each replacing one Pallas TPU kernel of
// src/repro/kernels/intersect/intersect.py:
//   <WRITE=1, CLASSIFY=1>  intersect_classify_write_indexed  (line 330)
//   <WRITE=0, CLASSIFY=1>  intersect_classify_count_indexed  (line 388)
//   <WRITE=1, CLASSIFY=0>  intersect_write_indexed           (line 101)
//   <WRITE=0, CLASSIFY=0>  intersect_count_indexed           (line 148)
//
// Design. The Pallas kernels walk a (pair, word block) grid in order: they
// zero the count on a pair's first word block and classify on its last.
// CUDA blocks run in no order, so here one CTA owns a whole pair: it loads
// its two row indices itself (the TPU's scalar prefetch), walks all W words
// grid-stride with 128-bit loads, ANDs, counts with __popc, stores the child
// coalesced, reduces the count with warp shuffles and one shared-memory
// step, and thread 0 classifies. No atomics, no second pass. Rows whose
// word count is a multiple of 4 on 16-byte-aligned storage take the uint4
// path; any other W takes a 32-bit path, so the kernel accepts every shape.
//
// Bound. About 0.4 integer operations per byte moved, so device memory
// bounds it: (unique parent-row bytes + pair bytes + child bytes written +
// 8 bytes of output per pair) / 3.35 TB/s on an H100 SXM. This simple form
// reads both rows of every pair from L2/HBM and leaves reuse of rows shared
// by neighbouring pairs to the L2 cache; ordering pairs for L2, TMA rings
// and persistent CTAs are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kSkip = 0;
constexpr int32_t kEmit = 1;
constexpr int32_t kStore = 2;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool WRITE, bool CLASSIFY>
__global__ void __launch_bounds__(kThreads)
intersect_indexed_kernel(const uint32_t* __restrict__ bits, int64_t t, int64_t W,
                         const int32_t* __restrict__ pairs,
                         const int32_t* __restrict__ pc, int32_t tau,
                         uint32_t* __restrict__ child, int32_t* __restrict__ cnt,
                         int32_t* __restrict__ cls, bool vec4) {
  __shared__ int partial[kWarps];
  const int64_t m = blockIdx.x;
  const int64_t i = pairs[2 * m];
  const int64_t j = pairs[2 * m + 1];
  if (i < 0 || i >= t || j < 0 || j >= t) __trap();  // a bad index is a caller bug
  const uint32_t* a = bits + i * W;
  const uint32_t* b = bits + j * W;

  int acc = 0;
  if (vec4) {
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* c4 = WRITE ? reinterpret_cast<uint4*>(child + m * W) : nullptr;
    const int64_t w4 = W >> 2;
#pragma unroll 4
    for (int64_t w = threadIdx.x; w < w4; w += kThreads) {
      const uint4 x = __ldg(a4 + w);
      const uint4 y = __ldg(b4 + w);
      const uint4 z = make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
      acc += __popc(z.x) + __popc(z.y) + __popc(z.z) + __popc(z.w);
      if (WRITE) c4[w] = z;
    }
  } else {
    uint32_t* c = WRITE ? child + m * W : nullptr;
    for (int64_t w = threadIdx.x; w < W; w += kThreads) {
      const uint32_t z = __ldg(a + w) & __ldg(b + w);
      acc += __popc(z);
      if (WRITE) c[w] = z;
    }
  }

  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? partial[lane] : 0);
    if (lane == 0) {
      cnt[m] = acc;
      if (CLASSIFY) {
        const int32_t minp = min(pc[i], pc[j]);
        cls[m] = (acc == 0 || acc == minp) ? kSkip : (acc <= tau ? kEmit : kStore);
      }
    }
  }
}

template <bool WRITE, bool CLASSIFY>
void launch(const void* bits, int64_t t, int64_t W, const void* pairs, int64_t M,
            const void* pc, int32_t tau, void* child, void* cnt, void* cls, bool vec4,
            cudaStream_t stream) {
  intersect_indexed_kernel<WRITE, CLASSIFY><<<static_cast<unsigned>(M), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(bits), t, W, static_cast<const int32_t*>(pairs),
      static_cast<const int32_t*>(pc), tau, static_cast<uint32_t*>(child),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(cls), vec4);
}

}  // namespace

extern "C" {

// Launch one instantiation on `stream`; returns cudaGetLastError() (0 = the
// launch was accepted). M must be >= 1: the caller skips empty batches.
int intersect_indexed(const void* bits, long long t, long long W, const void* pairs,
                      long long M, const void* pc, int tau, void* child, void* cnt,
                      void* cls, int write, int classify, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (write && classify) {
    launch<true, true>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  } else if (classify) {
    launch<false, true>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  } else if (write) {
    launch<true, false>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  } else {
    launch<false, false>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
