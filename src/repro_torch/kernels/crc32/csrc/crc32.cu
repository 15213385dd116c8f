// CRC-32 (zlib's: the reflected polynomial 0xEDB88320, register preset and
// final value inverted) of a tensor's row-major bytes, read in place on the
// card, for Hopper (sm_90a): the job checkpoint's integrity check.
//
// Replaces no Pallas kernel: the reference checksums a checkpoint's arrays
// on the host (src/repro/distributed/checkpoint.py, save_pytree,
// zlib.crc32 of a tobytes() copy). Here a level's bitsets stream from HBM to
// the checkpoint file once (distributed/checkpoint.py), and their CRC is
// taken on the card from the same HBM words, so no host pass over them is
// needed for it.
//
// The input is `rows` rows of `row_bytes` bytes, `pitch` bytes apart (a
// padded [rows, W_padded] word matrix viewed as its first n_words words:
// the padding is skipped, nothing is copied); the stream CRC'd is the rows
// back to back, L = rows * row_bytes bytes.
//
// Design. CRC-32 is linear over GF(2): for pieces A and B,
//   crc(A || B) = crc(A) * x^(8 |B|) mod P  ^  crc(B)
// (zlib's crc32_combine), so the CRC of the stream is the XOR over any
// split into pieces s of crc(s) * x^(8 * bytes after s). The stream is cut
// into tiles of kTile = 256 KiB; in a tile, thread t CRCs the kSeg = 1 KiB
// segment at t * kSeg with slicing-by-4 tables in shared memory (four
// lookups a word; 16-byte loads on one aligned row, 32-bit loads on padded
// word rows, bytes one at a time where the rows are not word-aligned). A
// block takes a contiguous run of whole tiles: each thread
// folds its segments of successive tiles by Horner's rule (acc = acc *
// x^(8 kTile) ^ crc), multiplies once by x^(8 (kTile - (t + 1) kSeg)), the
// bytes after its segment in a tile, and the block XORs its threads. The
// last block also takes the stream's partial tile. crc32_finish_kernel then
// shifts each block's CRC by the bytes after its run and XORs them: one
// uint32 on the card. The multipliers x^(8n) come from the table of
// x^(2^k) mod P (zlib's x2nmodp).
//
// Bound. Device memory: the L bytes read once, 2.56 ms for a level of
// 8.56 GB at 3.35 TB/s. Lookups: four shared-memory reads a word, at
// random banks; each multiplication by x^n is <= 32 shift-xor steps, two a
// thread and tile (0.3 instructions a byte beside the ~3 of the lookups).

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;
constexpr int kThreads = 256;
constexpr long long kSeg = 1024;                // bytes a thread CRCs in a tile
constexpr long long kTile = kSeg * kThreads;    // 256 KiB
constexpr int kMaxBlocks = 1024;                // partial CRCs the finish kernel reduces
constexpr int kFinishThreads = 1024;
constexpr int kMaxDevices = 64;

__constant__ uint32_t c_table[4][256];  // slicing-by-4: c_table[k][b] = b's CRC shifted by k bytes
__constant__ uint32_t c_x2n[32];        // x^(2^k) mod P

uint32_t h_table[4][256];
uint32_t h_x2n[32];
bool h_ready = false;
bool d_ready[kMaxDevices] = {};
std::mutex tables_mutex;

// a * b modulo P, bit-reflected (zlib's multmodp); a must not be 0 (every
// power of x is not)
__host__ __device__ inline uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (int i = 0; i < 32; ++i) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// x^(8 n) mod P
__device__ inline uint32_t x8nmodp(unsigned long long n) {
  uint32_t p = 1u << 31;  // x^0
  for (int k = 3; n; n >>= 1, ++k)
    if (n & 1) p = multmodp(c_x2n[k & 31], p);
  return p;
}

__device__ __forceinline__ uint32_t step_word(const uint32_t (*t)[256], uint32_t c, uint32_t w) {
  c ^= w;
  return t[3][c & 0xff] ^ t[2][(c >> 8) & 0xff] ^ t[1][(c >> 16) & 0xff] ^ t[0][c >> 24];
}

// How a segment reads the stream: one row 16-byte aligned (16-byte loads,
// a quarter of the L1 requests of word loads 1 KiB apart), word-aligned
// rows (32-bit loads), or anything else (bytes).
enum Mode { kBytes = 0, kWords = 1, kVec16 = 2 };

// zlib's CRC of the n bytes at logical offset o of the stream (o a
// multiple of 16)
__device__ uint32_t segment_crc(const uint32_t (*t)[256], const uint8_t* src, long long row_bytes,
                                long long pitch, int mode, long long o, long long n) {
  uint32_t c = 0xFFFFFFFFu;
  if (mode == kVec16) {
    const uint4* p = reinterpret_cast<const uint4*>(src + o);
    const long long nv = n >> 4;
    for (long long i = 0; i < nv; ++i) {
      const uint4 v = __ldg(p + i);
      c = step_word(t, c, v.x);
      c = step_word(t, c, v.y);
      c = step_word(t, c, v.z);
      c = step_word(t, c, v.w);
    }
    for (long long i = o + (nv << 4); i < o + n; ++i) c = t[0][(c ^ __ldg(src + i)) & 0xff] ^ (c >> 8);
  } else if (mode == kWords) {
    // whole words: a row holds wpr of them (one row: the stream's whole
    // words, then its last 1-3 bytes)
    const long long wpr = row_bytes >> 2, pw = pitch >> 2;
    const long long j = o >> 2;
    const long long row = wpr ? j / wpr : 0;
    long long col = j - row * wpr;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(src) + row * pw + col;
    const long long nw = n >> 2;
    for (long long i = 0; i < nw; ++i) {
      c = step_word(t, c, __ldg(p));
      ++p;
      if (++col == wpr) {
        col = 0;
        p += pw - wpr;
      }
    }
    for (long long i = o + (nw << 2); i < o + n; ++i) c = t[0][(c ^ __ldg(src + i)) & 0xff] ^ (c >> 8);
  } else {
    long long row = o / row_bytes, col = o - row * row_bytes;
    const uint8_t* p = src + row * pitch + col;
    for (long long i = 0; i < n; ++i) {
      c = t[0][(c ^ __ldg(p)) & 0xff] ^ (c >> 8);
      ++p;
      if (++col == row_bytes) {
        col = 0;
        p += pitch - row_bytes;
      }
    }
  }
  return c ^ 0xFFFFFFFFu;
}

__device__ inline uint32_t block_xor(uint32_t v, uint32_t* scratch) {
  for (int off = 16; off; off >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  uint32_t r = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) r ^= scratch[w];
  return r;
}

__global__ void __launch_bounds__(kThreads)
crc32_blocks_kernel(const uint8_t* __restrict__ src, long long row_bytes, long long pitch,
                    long long length, long long tiles_per_block, int mode,
                    uint32_t* __restrict__ partial) {
  __shared__ uint32_t t[4][256];
  __shared__ uint32_t scratch[kThreads / 32];
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x) (&t[0][0])[i] = (&c_table[0][0])[i];
  __syncthreads();

  const long long full = length / kTile, tail = length - full * kTile;
  const long long first = blockIdx.x * tiles_per_block;
  const long long last = first + tiles_per_block < full ? first + tiles_per_block : full;
  const long long seg = threadIdx.x * kSeg;
  uint32_t acc = 0;
  if (first < last) {
    const uint32_t tile_shift = x8nmodp(kTile);
    for (long long tile = first; tile < last; ++tile)
      acc = multmodp(tile_shift, acc) ^
            segment_crc(t, src, row_bytes, pitch, mode, tile * kTile + seg, kSeg);
    acc = multmodp(x8nmodp(kTile - seg - kSeg), acc);
  }
  if (blockIdx.x == gridDim.x - 1 && tail > 0) {
    // the stream's partial tile, after this block's whole ones
    const long long n = tail - seg < 0 ? 0 : (tail - seg < kSeg ? tail - seg : kSeg);
    acc = multmodp(x8nmodp(tail), acc);
    if (n > 0)
      acc ^= multmodp(x8nmodp(tail - seg - n),
                      segment_crc(t, src, row_bytes, pitch, mode, full * kTile + seg, n));
  }
  const uint32_t r = block_xor(acc, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = r;
}

__global__ void __launch_bounds__(kFinishThreads)
crc32_finish_kernel(const uint32_t* __restrict__ partial, int blocks, long long length,
                    long long tiles_per_block, uint32_t* __restrict__ out) {
  __shared__ uint32_t scratch[kFinishThreads / 32];
  uint32_t acc = 0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    const long long end = b == blocks - 1 ? length : (b + 1LL) * tiles_per_block * kTile;
    acc ^= multmodp(x8nmodp(static_cast<unsigned long long>(length - end)), partial[b]);
  }
  const uint32_t r = block_xor(acc, scratch);
  if (threadIdx.x == 0) out[0] = r;
}

void init_host_tables() {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    h_table[0][n] = c;
  }
  for (int n = 0; n < 256; ++n)
    for (int k = 1; k < 4; ++k) h_table[k][n] = (h_table[k - 1][n] >> 8) ^ h_table[0][h_table[k - 1][n] & 0xff];
  uint32_t p = 1u << 30;  // x^1
  h_x2n[0] = p;
  for (int n = 1; n < 32; ++n) h_x2n[n] = p = multmodp(p, p);
  h_ready = true;
}

// the tables in the current device's constant memory, once per device
cudaError_t ensure_tables(cudaStream_t s) {
  std::lock_guard<std::mutex> lock(tables_mutex);
  if (!h_ready) init_host_tables();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (d_ready[dev]) return cudaSuccess;
  err = cudaMemcpyToSymbolAsync(c_table, h_table, sizeof(h_table), 0, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) err = cudaMemcpyToSymbolAsync(c_x2n, h_x2n, sizeof(h_x2n), 0, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err == cudaSuccess) d_ready[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// Partial CRCs the scratch of crc32_rows must hold.
int crc32_max_blocks() { return kMaxBlocks; }

// Write zlib's CRC-32 of the rows * row_bytes bytes of `rows` rows at
// `src`, `pitch` bytes apart (pitch >= row_bytes; any pitch for one row),
// to out[0] (uint32), with partial (crc32_max_blocks() uint32) as scratch;
// launched on `stream`, returns the first CUDA error (0 = accepted). All on
// the current device.
int crc32_rows(const void* src, long long rows, long long row_bytes, long long pitch, void* partial,
               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long length = rows * row_bytes;
  if (length <= 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(uint32_t), s));
  cudaError_t err = ensure_tables(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 1) pitch = row_bytes;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const int mode = rows == 1 && addr % 16 == 0 ? kVec16
                   : addr % 4 == 0 && pitch % 4 == 0 && (rows == 1 || row_bytes % 4 == 0) ? kWords
                   : kBytes;
  const long long full = length / kTile;
  long long per_block = 1, blocks = 1;
  if (full > 0) {
    per_block = (full + kMaxBlocks - 1) / kMaxBlocks;
    blocks = (full + per_block - 1) / per_block;
  }
  crc32_blocks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(src), row_bytes, pitch, length, per_block, mode,
      static_cast<uint32_t*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  crc32_finish_kernel<<<1, kFinishThreads, 0, s>>>(static_cast<const uint32_t*>(partial),
                                                   static_cast<int>(blocks), length, per_block,
                                                   static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Copy `rows` rows of `width` bytes, `pitch` bytes apart on the device, to
// `dst` on the host (pinned), back to back; queued on `stream`, returns the
// CUDA error (0 = accepted).
int crc32_copy_rows(void* dst, const void* src, long long rows, long long width, long long pitch,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || width <= 0) return 0;
  if (rows == 1 || pitch == width)
    return static_cast<int>(cudaMemcpyAsync(dst, src, static_cast<size_t>(rows * width),
                                            cudaMemcpyDeviceToHost, s));
  return static_cast<int>(cudaMemcpy2DAsync(dst, static_cast<size_t>(width), src,
                                            static_cast<size_t>(pitch), static_cast<size_t>(width),
                                            static_cast<size_t>(rows), cudaMemcpyDeviceToHost, s));
}

const char* crc32_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
