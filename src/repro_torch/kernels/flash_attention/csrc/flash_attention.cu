// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../../_build.py).
//
// F1 flash_attention  <- repro/kernels/flash_attention/kernel.py::
//    flash_attention_bhsd (_flash_kernel). Layout q (B*H, Sq, hd), k and v
//    (B*Hkv, Sk, hd), all contiguous, float32 or bfloat16; the output
//    (B*H, Sq, hd) is in q's dtype. Query head bh reads kv head
//    b*Hkv + (bh % H) / (H/Hkv), as the reference's `kv_index` map does, so
//    K and V are never copied to H heads. The causal mask is aligned
//    bottom-right: query row i sits at key position i + Sk - Sq.
//
//    Numerics are the reference's: q.k^T, the online-softmax running max m
//    and sum l, and p.v all stay in fp32 (plain FMAs, no TF32); scores are
//    scaled by 1/sqrt(hd) after the dot product, masked scores take the
//    finite -1e30 (a -inf mask would give exp(-inf - -inf) = NaN on a row
//    whose keys so far are all masked), l is floored at 1e-30 before the
//    divide, and key tiles wholly above a query tile's diagonal are skipped.
//
//    Bound: the work is 4*hd FLOPs per (query, unmasked key) pair, which
//    the card could do at its bf16 tensor-core rate, against the bytes of
//    q, k, v read once and o written once. At the serving paths' prefill
//    (S 512) the bytes bound it; the FLOPs do only past S ~ 675 with
//    qwen2-7b's heads. This first version does not use the tensor cores: it
//    runs fp32 FMAs from shared memory, so it is bound by shared-memory
//    loads and the FMA rate, far above either bound.
//
//    Design: one CTA of 128 threads per (bh, tile of 64 query rows). The Q
//    tile is staged once in shared memory as fp32; the K and V tiles of 32
//    keys stream through shared memory one after another. Thread (rg, cg)
//    (16 row groups x 8 column groups) owns 4 query rows: it computes their
//    scores against keys cg, cg+8, cg+16, cg+24 of the tile, the 8 threads
//    of a row group reduce the row max and sum with warp shuffles, the
//    probabilities go to shared memory, and each thread accumulates the
//    float4 columns cg, cg+8, ... of its 4 output rows in registers. Rows
//    and keys past Sq and Sk are masked, so any length is taken without
//    padding: keys past Sk score -inf and contribute exactly nothing. There
//    is no split over Sk and no atomics: a row's bits depend only on its own
//    q row and its kv head, never on B or on the other rows of the launch.
//    Key tiles past a row's diagonal add exact zeros (p = exp(-1e30 - m) = 0
//    and the correction exp(m - m) = 1), so which tiles a CTA skips does not
//    change any row's bits either.
//
// The entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a launch that
// CUDA refused is reported by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include <cmath>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // keys per streamed tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / 8;   // keys per thread per tile
constexpr int kPS = kBK + 1;     // padded row stride of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage `rows` rows of hd elements from global memory into shared memory
// as fp32 with row stride `stride`; rows at or past `valid` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int rows, int valid) {
  constexpr int kVecs = HD / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    const float4 x = r < valid ? load4(src + static_cast<size_t>(r) * HD + c)
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
constexpr int smem_floats() {
  return kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * kPS;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int Sq,
          int Sk, int causal, float sm_scale) {
  constexpr int QS = HD + 4;              // padded stride of Q and K tiles
  constexpr int kVecs = HD / 4;           // float4 columns of a row
  constexpr int NF = (kVecs + 7) / 8;     // float4 columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * HD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* kg = k + static_cast<size_t>(kvh) * Sk * HD;
  const T* vg = v + static_cast<size_t>(kvh) * Sk * HD;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  const int q_rows = min(kBQ, Sq - q0);
  const int q_offset = Sk - Sq;

  load_tile<T, HD>(sQ, QS, q + (static_cast<size_t>(bh) * Sq + q0) * HD,
                   kBQ, q_rows);

  // A causal tile needs keys up to its last row's position. A tile with a
  // row before every key (Sq > Sk) reads all keys, so that row averages
  // over all of them, as the plain version's softmax over -1e30 does.
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
    load_tile<T, HD>(sK, QS, kg + static_cast<size_t>(k0) * HD, kBK,
                     k_valid);
    load_tile<T, HD>(sV, HD, vg + static_cast<size_t>(k0) * HD, kBK,
                     k_valid);
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
    T* out = o + (static_cast<size_t>(bh) * Sq + q0 + row) * HD;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int c = cg + 8 * f;
      if (c >= kVecs) continue;
      const float4 a = acc[i][f];
      store4(out + 4 * c, make_float4(a.x / den, a.y / den, a.z / den,
                                      a.w / den));
    }
  }
}

// The opt-in to more than 48 KB of dynamic shared memory, made once per
// instantiation and device rather than before every launch: serving issues
// one launch per layer and prefill, and its time is the host's.
template <typename T, int HD>
cudaError_t opt_in_smem(int bytes) {
  static std::atomic<unsigned long long> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int H, int Hkv, int Sq, int Sk, int causal,
                   float sm_scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  cudaError_t err = opt_in_smem<T, HD>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int BH, int H, int Hkv, int Sq, int Sk,
                        int causal, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, BH, H, Hkv, Sq, Sk, causal, sm_scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, BH, H, Hkv, Sq, Sk, causal, sm_scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, H, Hkv, Sq, Sk, causal, sm_scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. hd: 16, 64 or 128. The caller checks
// shapes, contiguity and 16-byte alignment of the four buffers.
int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int dtype, int BH, int H, int Hkv, int Sq, int Sk,
                       int hd, int causal, float sm_scale, void* stream) {
  if (BH <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || BH % H != 0 ||
      Sq <= 0 || Sk <= 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, BH, H, Hkv, Sq, Sk, causal,
                             sm_scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, BH, H, Hkv, Sq, Sk,
                                     causal, sm_scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
