// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../../_build.py).
//
// F1 flash_attention  <- repro/kernels/flash_attention/kernel.py::
//    flash_attention_bhsd (_flash_kernel). Element (b, s, h, :) of q, k, v
//    and o is read and written through the (batch, sequence, head) strides
//    the caller passes, so the model layout (B, S, H, hd) and the flattened
//    layout (B*H, S, hd) are both taken without a copy; the head dimension
//    is contiguous. Query head h reads kv head h / (H/Hkv), as the
//    reference's `kv_index` map does, so K and V are never copied to H
//    heads. The causal mask is aligned bottom-right: query row i sits at key
//    position i + Sk - Sq.
//
//    Semantics both kernels keep: scores are scaled by 1/sqrt(hd) after the
//    dot product; the online softmax keeps the running max m and sum l per
//    row in fp32; masked scores take the finite -1e30 (a -inf mask would
//    give exp(-inf - -inf) = NaN on a row whose keys so far are all
//    masked); keys past Sk score -inf and contribute exactly nothing; l is
//    floored at 1e-30 before the divide; key tiles wholly above a query
//    tile's diagonal are skipped, except that a tile holding a row before
//    every key (Sq > Sk) reads all Sk keys, so that row averages over all of
//    them as the plain version's softmax over -1e30 does. Any Sq and Sk are
//    taken, tails masked, with no padding. There is no split over Sk and no
//    atomics: a row's bits depend only on its own q row and its kv head,
//    never on B or on the layout's strides. Key tiles past a row's diagonal
//    add exact zeros (p = 0 and the correction exp(m - m) = 1), so which
//    tiles a CTA visits does not change any row's bits either.
//
//    Bound: the work is 4*hd FLOPs per (query, unmasked key) pair against
//    the bytes of q, k, v read once and o written once. At the serving
//    paths' prefill (S 512) the bytes bound it at the card's bf16
//    tensor-core rate; the FLOPs do only past S ~ 675 with qwen2-7b's heads
//    (28 query heads on 4 kv heads, hd 128), past S ~ 1180 with zamba2-7b's
//    (32 on 32, hd 112).
//
//    Dispatch is by dtype, not by size: every bfloat16 launch runs the
//    tensor-core kernel, every float32 launch the FMA kernel.
//
//    bfloat16: flash_fwd_tc, on the tensor cores. A work item is (b, h, a
//    tile of 128 query rows). The kernel is persistent: one CTA of 288
//    threads per SM walks the items, longest first for causal launches, in
//    snake order over the CTAs so that each gets a like share of key tiles.
//    In a CTA two consumer warpgroups own 64 rows of the item each and one
//    producer warp issues TMA. Two Q tiles and a ring of two stages of K
//    and V tiles of 128 keys come in through TMA, 128-byte swizzled, each
//    buffer guarded by full and empty mbarriers, so the next tile's copy
//    (and the next item's Q) overlaps this tile's products and this item's
//    epilogue. S = Q.K^T runs as wgmma
//    m64n128k16 with both operands read from shared memory (bf16 products
//    are exact in fp32 and sum in fp32, as the reference's f32 dot); the
//    online softmax runs on the fp32 accumulator in registers (ex2.approx
//    of scores scaled by log2(e)/sqrt(hd); tiles that mask nothing fold
//    the scale into the FFMA before it and skip the mask arithmetic, the
//    bulk of the instructions a tile issues); P is rounded to bf16 in
//    registers and fed as wgmma's register A operand against V read
//    MN-major from shared memory, as FlashAttention-2/3 do, while l sums
//    the fp32 p. Causal launches schedule the longest query tiles first.
//    The output is scaled by 1/l in registers and stored to its strides.
//    hd 16 runs the hd-64 tiles and hd 112 (zamba2-7b's shared block) the
//    hd-128 tiles: TMA fills the columns past hd with zeros, which add
//    nothing to either product, and only hd columns are stored. At hd 112
//    that wastes 16 of every 128 columns of both products (12.5 % of the
//    MMA work); the bytes, which bound the serving shapes, are hd's. The
//    tensor maps stay legal there: a bf16 row is 224 bytes and every
//    global stride a multiple of 16 bytes (7168 bytes a sequence step at
//    32 heads), and the scale is the caller's 1/sqrt(hd), not 1/sqrt(128).
//
//    Which CTA runs an item, and in what order, changes no bits: an item is
//    computed the same way wherever it runs.
//
//    float32: flash_fwd_fma keeps everything in fp32 FMAs (no TF32, which
//    would break the 2e-5 tolerance). One CTA of 128 threads per (b, h,
//    tile of 64 query rows); the Q tile is staged once in shared memory,
//    K and V tiles of 32 keys stream through it. Thread (rg, cg) (16 row
//    groups x 8 column groups) owns 4 query rows: it scores them against
//    keys cg, cg+8, cg+16, cg+24 of the tile, the 8 threads of a row group
//    reduce the row max and sum with warp shuffles, the probabilities go to
//    shared memory, and each thread accumulates float4 columns of its rows:
//    columns cg, cg+8, ... of the hd/4 (at hd 112, 28 columns over the 8
//    column groups, the last group's fourth slot idle). Shared memory is
//    67,328 bytes at hd 112 and 75,520 at hd 128, opted in past 48 KB.
//
// The entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (or the tensor-map
// encoder's failure as cudaErrorInvalidValue) so that a launch that CUDA
// refused is reported by the caller.

#include <cuda.h>               // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;

// The opt-in to more than 48 KB of dynamic shared memory, made once per
// kernel (the template argument, so each instantiation has its own flag)
// and device rather than before every launch: serving issues one
// launch per layer and prefill, and its time is the host's.
template <auto Kernel>
cudaError_t opt_in_smem(int bytes) {
  static std::atomic<unsigned long long> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The SM count of the current device, looked up once per device.
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

// Element strides of one tensor's (batch, sequence, head) dimensions.
struct Strides {
  int64_t b, s, h;
};

// ---------------------------------------------------------------- float32

namespace fma {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // keys per streamed tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / 8;   // keys per thread per tile
constexpr int kPS = kBK + 1;     // padded row stride of the P tile

// Stage `rows` rows of HD floats, row r at src + r*src_stride, into shared
// memory with row stride `stride`; rows at or past `valid` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src,
                                          int64_t src_stride, int rows,
                                          int valid) {
  constexpr int kVecs = HD / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const float4 x = r < valid
        ? *reinterpret_cast<const float4*>(src + r * src_stride + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * stride + c) = x;
  }
}

__device__ __forceinline__ float group_max(float x) {   // over 8 lanes
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {   // over 8 lanes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * (kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * kPS);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              Strides qs, Strides ks, Strides vs, Strides os, int H, int Hkv,
              int Sq, int Sk, int causal, float sm_scale) {
  constexpr int QS = HD + 4;              // padded stride of Q and K tiles
  constexpr int kVecs = HD / 4;           // float4 columns of a row
  constexpr int NF = (kVecs + 7) / 8;     // float4 columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * HD;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / Hkv);
  const float* kg = k + b * ks.b + kvh * ks.h;
  const float* vg = v + b * vs.b + kvh * vs.h;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  const int q_rows = min(kBQ, Sq - q0);
  const int q_offset = Sk - Sq;

  load_tile<HD>(sQ, QS, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, kBQ,
                q_rows);

  int k_end = Sk;
  if (causal && q0 + q_offset >= 0)
    k_end = min(Sk, q0 + q_rows + q_offset);

  float m[kRows], l[kRows];
  float4 acc[kRows][NF];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();            // the last tile's K, V and P are consumed
    const int k_valid = min(kBK, Sk - k0);
    load_tile<HD>(sK, QS, kg + k0 * ks.s, ks.s, kBK, k_valid);
    load_tile<HD>(sV, HD, vg + k0 * vs.s, vs.s, kBK, k_valid);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg * kRows + i) * QS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (cg + 8 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + rg * kRows + i + q_offset;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j] * sm_scale;
        if (kpos >= Sk) x = -INFINITY;
        else if (causal && kpos > qpos) x = kNegInf;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(rg * kRows + i) * kPS + cg + 8 * j] = p;
        row_sum += p;
      }
      l[i] = l[i] * corr + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        acc[i][f].x *= corr;
        acc[i][f].y *= corr;
        acc[i][f].z *= corr;
        acc[i][f].w *= corr;
      }
    }
    __syncthreads();            // the P tile is complete

    for (int kk = 0; kk < kBK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(rg * kRows + i) * kPS + kk];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int c = cg + 8 * f;
        if (c >= kVecs) continue;
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * HD + 4 * c);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][f].x = fmaf(p[i], vv.x, acc[i][f].x);
          acc[i][f].y = fmaf(p[i], vv.y, acc[i][f].y);
          acc[i][f].z = fmaf(p[i], vv.z, acc[i][f].z);
          acc[i][f].w = fmaf(p[i], vv.w, acc[i][f].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = rg * kRows + i;
    if (row >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* out = o + b * os.b + h * os.h + (q0 + row) * os.s;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int c = cg + 8 * f;
      if (c >= kVecs) continue;
      const float4 a = acc[i][f];
      *reinterpret_cast<float4*>(out + 4 * c) =
          make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int Hkv, int Sq, int Sk, int causal,
                   float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = opt_in_smem<flash_fwd_fma<HD>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_fma<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      H, Hkv, Sq, Sk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace fma

// --------------------------------------------------------------- bfloat16

namespace tc {

constexpr int kBM = 128;                 // query rows per CTA
constexpr int kBN = 128;                 // keys per K/V tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kConsumers = 256;          // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// Every operand tile is [HDP/64][rows][64] bf16: 128-byte rows, each block
// of 64 columns one TMA box, in the 128B-swizzled layout TMA writes and
// wgmma reads. Tiles start on 1024-byte boundaries (the swizzle atom).
template <int HDP>
struct Smem {
  alignas(1024) __nv_bfloat16 q[2][HDP / 64][kBM][64];
  alignas(1024) __nv_bfloat16 k[kStages][HDP / 64][kBN][64];
  alignas(1024) __nv_bfloat16 v[kStages][HDP / 64][kBN][64];
  alignas(8) uint64_t q_full[2], q_empty[2];
  uint64_t k_full[kStages], v_full[kStages], kv_empty[kStages];
};

// A work item: batch, head and first query row, longest first when causal.
struct Item {
  int b, h, q0;
};

__device__ __forceinline__ Item item_of(int it, int H, int BH, int n_qt,
                                        int causal) {
  const int rank = it / BH, bh = it % BH;
  return {bh / H, bh % H, (causal ? n_qt - 1 - rank : rank) * kBM};
}

// Key tiles an item reads: a causal item needs keys up to its last row's
// position, and all Sk keys when a row precedes every key (Sq > Sk), so
// that row averages over all of them as the plain softmax over -1e30 does.
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk,
                                         int causal) {
  int k_end = Sk;
  if (causal && q0 + Sk - Sq >= 0)
    k_end = min(Sk, q0 + min(kBM, Sq - q0) + Sk - Sq);
  return (k_end + kBN - 1) / kBN;
}

// The item this CTA runs in round r: snake order, so the CTA that takes
// one of the longest items in one round takes one of the shortest in the
// next. Returns -1 past the last item.
__device__ __forceinline__ int item_index(int r, int n_items) {
  const int it = r * gridDim.x
      + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return it < n_items ? it : -1;
}

template <int HDP>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<HDP>)) + 1024;   // + alignment slack
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One TMA box of the 4-D map (hd, seq, head, batch) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// D (64 x 128, fp32) {+}= A (64 x 16, smem) * B (128 x 16, smem)^T,
// both operands K-major in 128B-swizzled tiles.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem),
// B MN-major (N contiguous) in 128B-swizzled tiles.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem),
// B MN-major (N contiguous) in 128B-swizzled tiles.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&d)[HDP / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x in one MUFU instruction; -inf and large negative x give +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {   // over a row's 4 lanes
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// HD: the head dim stored; HDP: the tile width (64 or 128) it runs at.
template <int HD, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             __nv_bfloat16* __restrict__ o, Strides os, int B, int H,
             int Hkv, int Sq, int Sk, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem<HDP>& s = *reinterpret_cast<Smem<HDP>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int BH = B * H;
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int n_items = BH * n_qt;
  const int q_offset = Sk - Sq;
  constexpr uint32_t kTileBytes = kBN * HDP * 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], kConsumers / 32);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.kv_empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread keeps the Q pair and the K/V ring full
    if (threadIdx.x != kConsumers) return;
    int g = 0;                                   // K/V tiles issued
    for (int r = 0, it; (it = item_index(r, n_items)) >= 0; ++r) {
      const Item w = item_of(it, H, BH, n_qt, causal);
      const int kvh = w.h / (H / Hkv);
      const int qb = r & 1;
      mbar_wait(&s.q_empty[qb], ((r >> 1) & 1) ^ 1);
      mbar_expect_tx(&s.q_full[qb], kBM * HDP * 2);
#pragma unroll
      for (int c = 0; c < HDP / 64; ++c)
        tma_load(&s.q[qb][c][0][0], &q_map, &s.q_full[qb], 64 * c, w.q0,
                 w.h, w.b);
      const int n = key_tiles(w.q0, Sq, Sk, causal);
      for (int j = 0; j < n; ++j, ++g) {
        const int st = g % kStages;
        mbar_wait(&s.kv_empty[st], ((g / kStages) & 1) ^ 1);
        mbar_expect_tx(&s.k_full[st], kTileBytes);
#pragma unroll
        for (int c = 0; c < HDP / 64; ++c)
          tma_load(&s.k[st][c][0][0], &k_map, &s.k_full[st], 64 * c,
                   j * kBN, kvh, w.b);
        mbar_expect_tx(&s.v_full[st], kTileBytes);
#pragma unroll
        for (int c = 0; c < HDP / 64; ++c)
          tma_load(&s.v[st][c][0][0], &v_map, &s.v_full[st], 64 * c,
                   j * kBN, kvh, w.b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // this thread's accumulator rows r, r+8 and columns 8n + c, 8n + c + 1
  const int r = 16 * warp + lane / 4;
  const int c = 2 * (lane % 4);

  int g = 0;                                     // K/V tiles consumed
  for (int ri = 0, it; (it = item_index(ri, n_items)) >= 0; ++ri) {
    const Item w = item_of(it, H, BH, n_qt, causal);
    const int n = key_tiles(w.q0, Sq, Sk, causal);
    const int qb = ri & 1;
    const int qpos0 = w.q0 + 64 * wg + r + q_offset;   // key position of r
    const int qpos_first = w.q0 + 64 * wg + q_offset;  // of the first row

    float acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(&s.q_full[qb], (ri >> 1) & 1);
    for (int j = 0; j < n; ++j, ++g) {
      const int st = g % kStages;
      const uint32_t parity = (g / kStages) & 1;
      const int k0 = j * kBN;

      // S = Q K^T: HDP/16 steps of 16 columns; a step moves the start
      // address 32 bytes inside a 128-byte swizzled row
      float sc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
      mbar_wait(&s.k_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint64_t da =
            desc(&s.q[qb][kk / 4][64 * wg][16 * (kk % 4)], 16, 1024);
        const uint64_t db = desc(&s.k[st][kk / 4][0][16 * (kk % 4)], 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      if (j == n - 1) {            // the item's last read of its Q tile
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.q_empty[qb]);
      }

      // online softmax on the accumulator: sc[4n + e] is row r + 8*(e/2),
      // column k0 + 8n + c + e%2. A tile with a key past Sk or past the
      // first row of this warpgroup is scaled and masked element by
      // element; any other tile (the bulk) masks nothing, so its scale is
      // left to the FFMA that feeds exp2 (f, the scale still to apply).
      float mx[2] = {-INFINITY, -INFINITY};
      float f = 1.f;
      if (k0 + kBN > Sk || (causal && k0 + kBN - 1 > qpos_first)) {
#pragma unroll
        for (int t = 0; t < kBN / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * t + c + (e & 1);
            float x = sc[4 * t + e] * scale_log2;
            if (kpos >= Sk) x = -INFINITY;
            else if (causal && kpos > qpos0 + 8 * (e >> 1)) x = kNegInf;
            sc[4 * t + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      } else {
#pragma unroll
        for (int t = 0; t < kBN / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * t + e]);
        f = scale_log2;
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]) * f);
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      uint32_t pa[kBN / 16][4];     // P as wgmma's A fragments, 16 keys each
#pragma unroll
      for (int t = 0; t < kBN / 8; ++t) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(sc[4 * t + e], f, -m[e >> 1]));
          l[e >> 1] += p[e];
        }
        pa[t / 2][2 * (t % 2) + 0] = pack_bf16(p[0], p[1]);
        pa[t / 2][2 * (t % 2) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int t = 0; t < HDP / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * t + e] *= corr[e >> 1];

      // O += P V: V is MN-major (hd contiguous); a step of 16 keys moves
      // 16 rows = 2048 bytes; the two 64-column blocks are kBN rows apart
      mbar_wait(&s.v_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<HDP>(acc, pa[kk],
                      desc(&s.v[st][0][16 * kk][0], kBN * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.kv_empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-30f);
      const int row = w.q0 + 64 * wg + r + 8 * i;
      if (row >= Sq) continue;
      __nv_bfloat16* out = o + w.b * os.b + w.h * os.h + row * os.s;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t) {
        const __nv_bfloat162 x = __floats2bfloat162_rn(
            acc[4 * t + 2 * i] * inv, acc[4 * t + 2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * t + c) = x;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint, so the
// library links nothing but the CUDA runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-D map (hd, seq, head, batch) of a bf16 tensor with boxes of 64
// columns x `rows` rows, 128B-swizzled; reads out of bounds fill zeros.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads,
              int B, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B,
                   int H, int Hkv, int Sq, int Sk, int causal,
                   float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HDP>();
  cudaError_t err = opt_in_smem<flash_fwd_tc<HD, HDP>>(bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, HD, Sq, H, B, qs, kBM) ||
      !make_map(&k_map, k, HD, Sk, Hkv, B, ks, kBN) ||
      !make_map(&v_map, v, HD, Sk, Hkv, B, vs, kBN))
    return cudaErrorInvalidValue;
  int sms = 0;
  err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const int64_t items = static_cast<int64_t>(B) * H * ((Sq + kBM - 1) / kBM);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sms ? items : sms);
  flash_fwd_tc<HD, HDP><<<grid, kThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), os, B, H, Hkv,
      Sq, Sk, causal, sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 float32 (FMA kernel), 1 bfloat16 (tensor-core kernel). hd: 16,
// 64, 112 or 128; any other is refused (cudaErrorInvalidValue). `st` holds
// 12 element strides: (batch, seq, head) of q, k, v and o in that order. The caller checks shapes, that the head dimension is
// contiguous, and that every buffer and stride is a multiple of 16 bytes.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int dtype, int B, int H, int Hkv, int Sq, int Sk,
                       int hd, int64_t qb, int64_t qs_, int64_t qh,
                       int64_t kb, int64_t ks_, int64_t kh, int64_t vb,
                       int64_t vs_, int64_t vh, int64_t ob, int64_t os_,
                       int64_t oh, int causal, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      static_cast<int64_t>(B) * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qb, qs_, qh}, ks{kb, ks_, kh}, vs{vb, vs_, vh},
      os{ob, os_, oh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F1_ARGS q, k, v, o, qs, ks, vs, os, B, H, Hkv, Sq, Sk, causal, \
                sm_scale, s
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && B * H <= 65535) {
    if (hd == 16) err = fma::launch<16>(F1_ARGS);
    else if (hd == 64) err = fma::launch<64>(F1_ARGS);
    else if (hd == 112) err = fma::launch<112>(F1_ARGS);
    else if (hd == 128) err = fma::launch<128>(F1_ARGS);
  } else if (dtype == 1) {
    if (hd == 16) err = tc::launch<16, 64>(F1_ARGS);
    else if (hd == 64) err = tc::launch<64, 64>(F1_ARGS);
    else if (hd == 112) err = tc::launch<112, 128>(F1_ARGS);
    else if (hd == 128) err = tc::launch<128, 128>(F1_ARGS);
  }
#undef F1_ARGS
  return static_cast<int>(err);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
