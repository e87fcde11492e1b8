// Checkpoint checksum kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../_build.py).
//
// All three kernels read a leaf's little-endian byte stream directly: a word
// is the 4 bytes at offset 4*i, and bytes past `nbytes` read as zero. That is
// exactly the word stream of `ref.byte_view` zero-padded to whole words and
// whole 4 KB tiles, so no padded copy of the leaf is ever made. All
// arithmetic is uint32 and wraps mod 2^32, which is the checksum's
// definition.
//
// K1 tile_checksums  <- repro/kernels/checksum/kernel.py::tile_checksum_kernel
//    (_tile_checksum_kernel). Per 4 KB tile of 1024 words one row
//      s0 = sum w,  s1 = sum (j+1) w,  m = sum (w ^ w>>16) * 0x9E3779B1.
//    Bound: memory, a read of 4n bytes (and 12 B per tile written); about
//    seven integer operations per 4 bytes is far below the card's ridge.
//    Design: one warp per tile, eight tiles per 256-thread block. Lane l
//    loads the 16-byte vectors l, l+32, ..., l+224 of its tile, so each load
//    instruction of the warp covers 512 contiguous bytes. The three sums are
//    reduced with warp shuffles and lane 0 writes the 12-byte row. No shared
//    memory, no atomics, no cross-block state.
//
// K2 checksum_words  <- repro/kernels/checksum/kernel.py::checksum_kernel
//    (_checksum_kernel). Whole-stream s0 = sum w, s1 = sum (i+1) w with the
//    global word index i. Bound: memory, a read of 4n bytes.
//    Design: the TPU kernel carries two SMEM scalars across a sequential
//    grid; Hopper blocks run in no order, so each thread strides over 16-byte
//    vectors with its global word index, the block reduces its partials
//    (warp shuffles, then one warp over the per-warp sums in shared memory)
//    and folds them into the two output words with atomicAdd on unsigned int.
//    Addition mod 2^32 is associative and commutative, so every order of the
//    atomics gives the same bits. The caller zeroes the two output words.
//
// K3 gather_tiles    <- repro/kernels/checksum/kernel.py::gather_tiles_kernel
//    (_gather_tiles_kernel). Copies tile idx[i] of the byte stream to row i
//    of a compact (k, 1024) word buffer; the trailing partial tile is zero
//    padded. Bound: memory, k * 4 KB read and k * 4 KB written; at the
//    sparse-dirt path's 1,228 tiles that is 10 MB, 3 us at the card's rate,
//    so the copy must have enough bytes in flight from the first cycle.
//    Design: scalar prefetch has no counterpart, so a block reads its own
//    indices. A block of 256 threads takes 8 tiles at a time: each thread
//    issues its 16-byte load in all 8 (8 independent loads in flight per
//    thread, 32 KB per block) before it stores any, and blocks stride over
//    the index list. The grid is ceil(k / 8) blocks, capped at 8 per SM (a
//    wave or two: 53 registers a thread leave room for 4 resident blocks),
//    so a few hundred tiles fill the card at once.
//
// Each entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a launch the
// driver refused is reported by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileWords = 1024;
constexpr int kTileBytes = kTileWords * 4;
constexpr int kVecPerTile = kTileBytes / 16;          // 256 uint4 per tile
constexpr unsigned kMixC = 0x9E3779B1u;

__device__ __forceinline__ unsigned mix(unsigned w) {
  return (w ^ (w >> 16)) * kMixC;
}

// The 16 bytes at byte offset `off` as four little-endian words, zero past
// `nbytes`. `base` is 16-byte aligned, so an in-bounds vector is one load.
__device__ __forceinline__ uint4 load_vec(const uint8_t* __restrict__ base,
                                          int64_t off, int64_t nbytes) {
  if (off + 16 <= nbytes) {
    return __ldg(reinterpret_cast<const uint4*>(base + off));
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 16; ++b) {
    const int64_t p = off + b;
    if (p < nbytes) w[b >> 2] |= static_cast<unsigned>(base[p]) << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void tile_checksums_kernel(const uint8_t* __restrict__ data,
                                      int64_t nbytes, int64_t n_tiles,
                                      unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                       + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int64_t tile_off = tile * kTileBytes;
  unsigned s0 = 0u, s1 = 0u, m = 0u;
#pragma unroll
  for (int k = 0; k < kVecPerTile / 32; ++k) {
    const int v = lane + 32 * k;                     // vector index in tile
    const uint4 q = load_vec(data, tile_off + 16 * static_cast<int64_t>(v),
                             nbytes);
    const unsigned j1 = 4u * v + 1u;                 // local weight of q.x
    s0 += q.x + q.y + q.z + q.w;
    s1 += j1 * q.x + (j1 + 1u) * q.y + (j1 + 2u) * q.z + (j1 + 3u) * q.w;
    m += mix(q.x) + mix(q.y) + mix(q.z) + mix(q.w);
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  m = warp_sum(m);
  if (lane == 0) {
    out[3 * tile + 0] = s0;
    out[3 * tile + 1] = s1;
    out[3 * tile + 2] = m;
  }
}

__global__ void checksum_words_kernel(const uint8_t* __restrict__ data,
                                      int64_t nbytes,
                                      unsigned* __restrict__ out) {
  __shared__ unsigned part0[32];
  __shared__ unsigned part1[32];
  const int64_t n_vec = (nbytes + 15) / 16;
  unsigned s0 = 0u, s1 = 0u;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_vec; v += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint4 q = load_vec(data, 16 * v, nbytes);
    const unsigned i1 = static_cast<unsigned>(4 * v + 1);   // weight mod 2^32
    s0 += q.x + q.y + q.z + q.w;
    s1 += i1 * q.x + (i1 + 1u) * q.y + (i1 + 2u) * q.z + (i1 + 3u) * q.w;
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part0[warp] = s0;
    part1[warp] = s1;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    s0 = lane < n_warps ? part0[lane] : 0u;
    s1 = lane < n_warps ? part1[lane] : 0u;
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      atomicAdd(out + 0, s0);
      atomicAdd(out + 1, s1);
    }
  }
}

constexpr int kGatherTiles = 8;     // tiles a block copies per pass

__global__ void gather_tiles_kernel(const uint8_t* __restrict__ data,
                                    int64_t nbytes,
                                    const int32_t* __restrict__ idx,
                                    int64_t k, uint4* __restrict__ out) {
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * kGatherTiles;
       row0 < k; row0 += static_cast<int64_t>(gridDim.x) * kGatherTiles) {
    uint4 x[kGatherTiles];
#pragma unroll
    for (int i = 0; i < kGatherTiles; ++i) {
      if (row0 + i < k) {
        const int64_t src = static_cast<int64_t>(idx[row0 + i]) * kTileBytes
                            + 16 * static_cast<int64_t>(threadIdx.x);
        x[i] = load_vec(data, src, nbytes);
      }
    }
#pragma unroll
    for (int i = 0; i < kGatherTiles; ++i) {
      if (row0 + i < k) out[(row0 + i) * kVecPerTile + threadIdx.x] = x[i];
    }
  }
}

// The SM count of the current device, looked up once per device: K3's
// launch is issued on the host's critical path.
cudaError_t device_sms(int* out) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = cached[dev & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev & 63].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out: (n_tiles, 3) uint32, n_tiles = ceil(nbytes / 4096) >= 1.
int rt_tile_checksums(const void* data, int64_t nbytes, int64_t n_tiles,
                      void* out, void* stream) {
  constexpr int kThreads = 256;
  constexpr int kTilesPerBlock = kThreads / 32;
  const int64_t blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  tile_checksums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, n_tiles,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out: 2 uint32 words, zeroed by the caller; accumulates (s0, s1).
int rt_checksum_words(const void* data, int64_t nbytes, int sm_count,
                      void* out, void* stream) {
  constexpr int kThreads = 512;
  const int64_t n_vec = (nbytes + 15) / 16;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count) * 4;   // a few waves
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  checksum_words_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// idx: (k,) int32 tile indices, each < ceil(nbytes / 4096), k >= 1; out:
// (k, 1024) uint32, 16-byte aligned.
int rt_gather_tiles(const void* data, int64_t nbytes, const void* idx,
                    int64_t k, void* out, void* stream) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (k + kGatherTiles - 1) / kGatherTiles;
  const int64_t cap = static_cast<int64_t>(sms) * 8;   // a wave or two
  if (blocks > cap) blocks = cap;
  gather_tiles_kernel<<<static_cast<unsigned>(blocks), kVecPerTile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes,
      static_cast<const int32_t*>(idx), k, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
