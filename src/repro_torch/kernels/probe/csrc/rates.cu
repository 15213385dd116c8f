// Throughput probes for Hopper (sm_90a): the rates that price the smoke's
// AND-popcount bounds, measured on the card instead of taken from a table.
//
// * kind 0, lop3: 32-bit three-input logic (lop3.b32), the AND and the
//   carry-save (Harley-Seal) steps of a sum of popcounts of ANDs;
// * kind 1, popc: 32-bit population count (__popc);
// * kind 2, mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc;
// * kind 3, mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
//   A b1 mma counts as M * N * K bit products (an AND and its share of a
//   popcount each).
//
// Each kernel runs kChains independent dependence chains in every thread
// (kMmaChains accumulators in every warp), 8 CTAs of 256 threads per SM,
// `iters` rounds of kUnroll steps, and stores what it computed so that
// nothing is eliminated. The lop3 chains mix three live values each step
// (never a constant), so the compiler cannot fold two steps into one LOP3.
// probe_rate launches one kernel between two CUDA events on the caller's
// stream, waits for it and returns its time; the caller sizes `iters` so
// that a run takes tens of milliseconds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;      // independent chains per thread (lop3, popc)
constexpr int kMmaChains = 4;   // independent accumulators per warp (mma)
constexpr int kUnroll = 16;     // steps per loop round

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

__device__ __forceinline__ uint32_t seed_of(int j) {
  return (blockIdx.x * kThreads + threadIdx.x) * 2654435761u + static_cast<uint32_t>(j) * 40503u;
}

__global__ void __launch_bounds__(kThreads) lop3_kernel(long long iters, uint32_t* out) {
  uint32_t r[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) r[j] = seed_of(j);
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        // full-adder sum (0x96) and carry (0xE8) of three chains, as a
        // carry-save step computes them
        const uint32_t b = r[(j + 1) % kChains], c = r[(j + 3) % kChains];
        r[j] = (j & 1) ? lop3<0xE8>(r[j], b, c) : lop3<0x96>(r[j], b, c);
      }
    }
  }
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) x ^= r[j];
  out[blockIdx.x * kThreads + threadIdx.x] = x;
}

__global__ void __launch_bounds__(kThreads) popc_kernel(long long iters, uint32_t* out) {
  uint32_t r[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) r[j] = seed_of(j);
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) r[j] = __popc(r[j]) + r[(j + 1) % kChains];
    }
  }
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) x ^= r[j];
  out[blockIdx.x * kThreads + threadIdx.x] = x;
}

__global__ void __launch_bounds__(kThreads) mma_m8n8k128_kernel(long long iters, uint32_t* out) {
  uint32_t a[kMmaChains], b[kMmaChains];
  int32_t c[kMmaChains][2];
#pragma unroll
  for (int j = 0; j < kMmaChains; ++j) {
    a[j] = seed_of(j);
    b[j] = seed_of(j + kMmaChains);
    c[j][0] = c[j][1] = j;
  }
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < kUnroll / 4; ++s) {
#pragma unroll
      for (int j = 0; j < kMmaChains; ++j) {
        asm volatile(
            "mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1}, {%2}, {%3}, {%0, %1};"
            : "+r"(c[j][0]), "+r"(c[j][1])
            : "r"(a[j]), "r"(b[j]));
      }
    }
  }
  int32_t x = 0;
#pragma unroll
  for (int j = 0; j < kMmaChains; ++j) x ^= c[j][0] ^ c[j][1];
  out[blockIdx.x * kThreads + threadIdx.x] = static_cast<uint32_t>(x);
}

__global__ void __launch_bounds__(kThreads) mma_m16n8k256_kernel(long long iters, uint32_t* out) {
  uint32_t a[kMmaChains][4], b[kMmaChains][2];
  int32_t c[kMmaChains][4];
#pragma unroll
  for (int j = 0; j < kMmaChains; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[j][q] = seed_of(4 * j + q);
      c[j][q] = j + q;
    }
    b[j][0] = seed_of(100 + j);
    b[j][1] = seed_of(200 + j);
  }
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < kUnroll / 4; ++s) {
#pragma unroll
      for (int j = 0; j < kMmaChains; ++j) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]), "r"(b[j][0]), "r"(b[j][1]));
      }
    }
  }
  int32_t x = 0;
#pragma unroll
  for (int j = 0; j < kMmaChains; ++j) x ^= c[j][0] ^ c[j][1] ^ c[j][2] ^ c[j][3];
  out[blockIdx.x * kThreads + threadIdx.x] = static_cast<uint32_t>(x);
}

}  // namespace

extern "C" {

int probe_threads_per_cta() { return kThreads; }

// Launch probe `kind` (0-3, above) on `n_ctas` CTAs of probe_threads_per_cta()
// threads for `iters` rounds on `stream`, wait for it, and write its time in
// milliseconds to *ms and the operations it did to *ops (lop3 and popc:
// instructions of one thread summed over threads; mma: bit products).
// `out` holds n_ctas * probe_threads_per_cta() uint32 words. Returns the
// first CUDA error (0 = ran), or -1 for an unknown kind.
int probe_rate(int kind, long long n_ctas, long long iters, void* out, void* stream, float* ms,
               double* ops) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  const double threads = static_cast<double>(n_ctas) * kThreads;
  const double warps = threads / 32.0;
  const double rounds = static_cast<double>(iters);
  double n_ops = 0.0;
  switch (kind) {
    case 0: case 1: n_ops = threads * rounds * kUnroll * kChains; break;
    case 2: n_ops = warps * rounds * (kUnroll / 4) * kMmaChains * 8.0 * 8.0 * 128.0; break;
    case 3: n_ops = warps * rounds * (kUnroll / 4) * kMmaChains * 16.0 * 8.0 * 256.0; break;
    default: return -1;
  }
  cudaEvent_t start, end;
  cudaError_t err = cudaEventCreate(&start);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaEventCreate(&end);
  if (err != cudaSuccess) {
    cudaEventDestroy(start);
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_ctas));
  err = cudaEventRecord(start, s);
  if (err == cudaSuccess) {
    switch (kind) {
      case 0: lop3_kernel<<<grid, kThreads, 0, s>>>(iters, o); break;
      case 1: popc_kernel<<<grid, kThreads, 0, s>>>(iters, o); break;
      case 2: mma_m8n8k128_kernel<<<grid, kThreads, 0, s>>>(iters, o); break;
      default: mma_m16n8k256_kernel<<<grid, kThreads, 0, s>>>(iters, o); break;
    }
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = cudaEventRecord(end, s);
  if (err == cudaSuccess) err = cudaEventSynchronize(end);
  if (err == cudaSuccess) err = cudaEventElapsedTime(ms, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  *ops = n_ops;
  return static_cast<int>(err);
}

const char* probe_error_string(int code) {
  return code == -1 ? "unknown probe kind" : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
