// Bitset intersection for Hopper (sm_90a): the paper's bottleneck, Alg. 1
// line 31, with the classification of lines 32-41 fused in.
//
// For each pair m with rows (i, j) of the (t, W) parent bitsets:
//   child[m] = bits[i] & bits[j]                     (WRITE)
//   cnt[m]   = popcount(child[m])
//   cls[m]   = SKIP  if cnt == 0 or cnt == min(pc[i], pc[j])   (CLASSIFY)
//              EMIT  if cnt <= tau
//              STORE otherwise
//
// Two templates, each replacing one family of Pallas TPU kernels of
// src/repro/kernels/intersect/intersect.py.
//
// Indexed: the kernel reads (i, j) = pairs[m] and the parent rows itself.
//   <WRITE=1, CLASSIFY=1>  intersect_classify_write_indexed  (line 330)
//   <WRITE=0, CLASSIFY=1>  intersect_classify_count_indexed  (line 388)
//   <WRITE=1, CLASSIFY=0>  intersect_write_indexed           (line 101)
//   <WRITE=0, CLASSIFY=0>  intersect_count_indexed           (line 148)
//
// Gathered: the caller has gathered the operand rows, a[m] = bits[i] and
// b[m] = bits[j], both (M, W), and minp[m] = min(pc[i], pc[j]).
//   <WRITE=1, CLASSIFY=1, INPLACE=0>  intersect_classify_write_gathered (line 467, jit 521)
//   <WRITE=1, CLASSIFY=1, INPLACE=1>  intersect_classify_write_gathered_donating (jit 529)
//   <WRITE=0, CLASSIFY=1, INPLACE=0>  intersect_classify_count_gathered (line 537)
//   <WRITE=1, CLASSIFY=0, INPLACE=0>  intersect_write_gathered          (line 208)
//   <WRITE=0, CLASSIFY=0, INPLACE=0>  intersect_count_gathered          (line 244)
// INPLACE writes the child over a, as the donating jit aliases its child
// output onto a's buffer: the write path then allocates no child.
//
// Design. The Pallas kernels walk a (pair, word block) grid in order: they
// zero the count on a pair's first word block and classify on its last.
// CUDA blocks run in no order, so here one CTA owns a whole pair: it finds
// its two rows (indexed: from its pair's indices, the TPU's scalar
// prefetch; gathered: at a + m*W and b + m*W), walks all W words
// grid-stride with 128-bit loads, ANDs, counts with __popc, stores the child
// coalesced, reduces the count with warp shuffles and one shared-memory
// step, and thread 0 classifies. No atomics, no second pass. Rows whose
// word count is a multiple of 4 on 16-byte-aligned storage take the uint4
// path; any other W takes a 32-bit path, so the kernels accept every shape.
//
// Bound. About 0.4 integer operations per byte moved, so device memory
// bounds both: (parent-row or operand bytes read + child bytes written +
// 8-12 bytes per pair of indices, counts and classes) / 3.35 TB/s on an
// H100 SXM. The indexed form reads each parent row from L2/HBM per pair and
// leaves reuse of rows shared by neighbouring pairs to the L2 cache; the
// gathered form streams two (M, W) operands once. Ordering pairs for L2,
// TMA rings and persistent CTAs are later work.

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

// Sum of every thread's v over the CTA; the total is valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int partial[kWarps];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < kWarps ? partial[lane] : 0);
  return v;
}

// Alg. 1 lines 32-41 for one pair's count and its smaller parent count.
__device__ __forceinline__ int32_t classify(int acc, int32_t minp, int32_t tau) {
  return (acc == 0 || acc == minp) ? kSkip : (acc <= tau ? kEmit : kStore);
}

template <bool WRITE, bool CLASSIFY>
__global__ void __launch_bounds__(kThreads)
intersect_indexed_kernel(const uint32_t* __restrict__ bits, int64_t t, int64_t W,
                         const int32_t* __restrict__ pairs,
                         const int32_t* __restrict__ pc, int32_t tau,
                         uint32_t* __restrict__ child, int32_t* __restrict__ cnt,
                         int32_t* __restrict__ cls, bool vec4) {
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

  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    cnt[m] = acc;
    if (CLASSIFY) cls[m] = classify(acc, min(pc[i], pc[j]), tau);
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

// Loads through the read-only data cache (__ldg), except where the kernel
// writes the same memory (INPLACE): a non-coherent load of memory the kernel
// also stores to is undefined. There each thread reads its own words and
// then writes them, so plain loads need no ordering across threads.
template <bool LDG, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (LDG) {
    return __ldg(p);
  } else {
    return *p;
  }
}

template <bool WRITE, bool CLASSIFY, bool INPLACE>
__global__ void __launch_bounds__(kThreads)
intersect_gathered_kernel(uint32_t* a, const uint32_t* b, int64_t W,
                          const int32_t* minp, int32_t tau, uint32_t* child,
                          int32_t* cnt, int32_t* cls, bool vec4) {
  static_assert(!INPLACE || WRITE, "an in-place kernel writes the child");
  const int64_t m = blockIdx.x;
  // no __restrict__ on the in-place kernel's rows: its child is a
  uint32_t* ra = a + m * W;
  const uint32_t* rb = b + m * W;
  uint32_t* rc = INPLACE ? ra : (WRITE ? child + m * W : nullptr);

  int acc = 0;
  if (vec4) {
    const uint4* a4 = reinterpret_cast<const uint4*>(ra);
    const uint4* b4 = reinterpret_cast<const uint4*>(rb);
    uint4* c4 = reinterpret_cast<uint4*>(rc);
    const int64_t w4 = W >> 2;
#pragma unroll 4
    for (int64_t w = threadIdx.x; w < w4; w += kThreads) {
      const uint4 x = load<!INPLACE>(a4 + w);
      const uint4 y = load<!INPLACE>(b4 + w);
      const uint4 z = make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
      acc += __popc(z.x) + __popc(z.y) + __popc(z.z) + __popc(z.w);
      if (WRITE) c4[w] = z;
    }
  } else {
    for (int64_t w = threadIdx.x; w < W; w += kThreads) {
      const uint32_t z = load<!INPLACE>(ra + w) & load<!INPLACE>(rb + w);
      acc += __popc(z);
      if (WRITE) rc[w] = z;
    }
  }

  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    cnt[m] = acc;
    if (CLASSIFY) cls[m] = classify(acc, minp[m], tau);
  }
}

template <bool WRITE, bool CLASSIFY, bool INPLACE>
void launch_gathered(void* a, const void* b, int64_t W, int64_t M, const void* minp,
                     int32_t tau, void* child, void* cnt, void* cls, bool vec4,
                     cudaStream_t stream) {
  intersect_gathered_kernel<WRITE, CLASSIFY, INPLACE>
      <<<static_cast<unsigned>(M), kThreads, 0, stream>>>(
          static_cast<uint32_t*>(a), static_cast<const uint32_t*>(b), W,
          static_cast<const int32_t*>(minp), tau, static_cast<uint32_t*>(child),
          static_cast<int32_t*>(cnt), static_cast<int32_t*>(cls), vec4);
}

// Record `event` (a cudaEvent_t, or null for none) on `s`.
int record(void* event, cudaStream_t s) {
  return event ? static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), s)) : 0;
}

}  // namespace

extern "C" {

// Launch one instantiation on `stream`; returns cudaGetLastError() (0 = the
// launch was accepted). M must be >= 1: the caller skips empty batches.
// `start` and `end` (cudaEvent_t, or null) are recorded on `stream` just
// before and just after the launch, so they time the kernel alone.
int intersect_indexed(const void* bits, long long t, long long W, const void* pairs,
                      long long M, const void* pc, int tau, void* child, void* cnt,
                      void* cls, int write, int classify, int vec4, void* stream,
                      void* start, void* end) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = record(start, s)) return err;
  if (write && classify) {
    launch<true, true>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  } else if (classify) {
    launch<false, true>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  } else if (write) {
    launch<true, false>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  } else {
    launch<false, false>(bits, t, W, pairs, M, pc, tau, child, cnt, cls, vec4, s);
  }
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  return record(end, s);
}

// Launch one gathered instantiation on `stream`: a, b are (M, W) operand
// rows, minp (M,) (classify only), child (M, W) (write, not in place).
// inplace = 1 writes the child over a (write and classify only). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an in-place request
// without write + classify. M must be >= 1. `start` and `end` as for
// intersect_indexed.
int intersect_gathered(void* a, const void* b, long long W, long long M, const void* minp,
                       int tau, void* child, void* cnt, void* cls, int write, int classify,
                       int inplace, int vec4, void* stream, void* start, void* end) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inplace && !(write && classify)) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = record(start, s)) return err;
  if (inplace) {
    launch_gathered<true, true, true>(a, b, W, M, minp, tau, nullptr, cnt, cls, vec4, s);
  } else if (write && classify) {
    launch_gathered<true, true, false>(a, b, W, M, minp, tau, child, cnt, cls, vec4, s);
  } else if (classify) {
    launch_gathered<false, true, false>(a, b, W, M, minp, tau, nullptr, cnt, cls, vec4, s);
  } else if (write) {
    launch_gathered<true, false, false>(a, b, W, M, minp, tau, child, cnt, nullptr, vec4, s);
  } else {
    launch_gathered<false, false, false>(a, b, W, M, minp, tau, nullptr, cnt, nullptr, vec4, s);
  }
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  return record(end, s);
}

const char* intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
