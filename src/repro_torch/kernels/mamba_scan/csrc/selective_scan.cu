// Mamba1 selective scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../../_build.py).
//
// S1 selective_scan  <- repro/kernels/mamba_scan/kernel.py::selective_scan
//    (_scan_kernel). For every batch row b and channel d of d_inner, with
//    h_{-1} = 0:
//        h_t = exp(dt_t * A_d) * h_{t-1} + (dt_t * x_t) * B_t    (ds states)
//        y_t = sum_s h_t[s] * C_t[s]
//    x, dt and y are (b, S, di), B and C (b, S, ds), A (di, ds), all float32
//    and contiguous; h_final is (b, di, ds) float32. The order of
//    operations is the reference's: dA = expf(dt * A) (the accurate expf,
//    no fast-math), then (dt * x) * B; FMA contraction and the order of the
//    sum over s differ from the plain version, so the two agree within
//    1e-4, not bit for bit.
//
//    Bound: per step and channel, ds exps and about 4*ds FLOPs against 12
//    bytes of x, dt and y (B, C and A are shared by every channel). At
//    falcon-mamba-7b's prefill (b 4, S 512, di 8192, ds 16) that is 204 MB,
//    0.061 ms at 3.35 TB/s, against 268 M exps and 1.1 GFLOP, 0.02 ms at
//    67 T/s: the bytes bound it, with the SFU's exp rate close behind.
//
//    Design: the reference walks a sequential grid over chunks of S and
//    carries a (block_d, ds) state stripe in VMEM. On Hopper blocks run in
//    no order, so the loop over t runs inside the kernel: one thread owns
//    one (b, d) channel and keeps its ds states, and its row of A, in
//    registers from t = 0 to S-1. Nothing is carried between blocks.
//    Neighbouring threads take neighbouring d, so each step's loads of x
//    and dt and store of y coalesce. B_t and C_t are the same for every
//    channel of a batch row: a block stages kT steps of them in shared
//    memory at a time, double-buffered, and loads the next kT steps of its
//    x and dt into registers before it computes the current ones, so the
//    loads of a chunk are in flight while the previous chunk computes.
//    Tails in S and di are masked; any S >= 1 and di >= 1 are taken.
//
//    What bounds this layout: one thread per channel gives b * di threads,
//    32,768 (about 8 warps per SM) at the main path's shape, each running a
//    dependent loop of S steps. The ds states of a step are independent,
//    which gives each thread ds-way instruction parallelism, but with so
//    few warps the exp and FMA latency, not the bytes, is expected to set
//    the time. Splitting ds across lanes (with a shuffle reduction for y)
//    would give ds times the threads; that is later work.
//
//    Each channel's result depends only on its own x, dt and A row and on
//    B and C of its batch row, through the same instructions in every
//    launch: a lane's bits do not depend on the batch it is launched in.
//
// The entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a launch that
// CUDA refused is reported by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kT = 8;           // steps staged per chunk

// B and C of steps [t0, t0 + kT) of one batch row into shared memory,
// zeros past S; all threads of the block take part.
template <int DS>
__device__ __forceinline__ void stage(float (&sb)[kT][DS],
                                      float (&sc)[kT][DS],
                                      const float* __restrict__ Bm,
                                      const float* __restrict__ Cm,
                                      size_t row, int t0, int S) {
  for (int i = threadIdx.x; i < kT * DS; i += kThreads) {
    const int tt = i / DS, s = i % DS, t = t0 + tt;
    const size_t at = (row + t) * DS + s;
    sb[tt][s] = t < S ? Bm[at] : 0.f;
    sc[tt][s] = t < S ? Cm[at] : 0.f;
  }
}

// One thread's x and dt of steps [t0, t0 + kT) into registers, zeros past S.
__device__ __forceinline__ void load(const float* __restrict__ x,
                                     const float* __restrict__ dt,
                                     float (&xr)[kT], float (&dr)[kT],
                                     size_t row, int t0, int S, int di, int d,
                                     bool live) {
#pragma unroll
  for (int tt = 0; tt < kT; ++tt) {
    const int t = t0 + tt;
    const bool ok = live && t < S;
    const size_t at = (row + t) * di + d;
    xr[tt] = ok ? x[at] : 0.f;
    dr[tt] = ok ? dt[at] : 0.f;
  }
}

template <int DS>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, float* __restrict__ y,
                   float* __restrict__ hout, int S, int di) {
  __shared__ __align__(16) float sB[2][kT][DS];
  __shared__ __align__(16) float sC[2][kT][DS];

  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const size_t row = static_cast<size_t>(blockIdx.y) * S;  // first step

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = live ? A[static_cast<size_t>(d) * DS + s] : 0.f;
    h[s] = 0.f;
  }

  float xc[kT], dc[kT], xn[kT], dn[kT];
  stage<DS>(sB[0], sC[0], Bm, Cm, row, 0, S);
  load(x, dt, xc, dc, row, 0, S, di, d, live);
  __syncthreads();

  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kT, buf ^= 1) {
    const bool more = t0 + kT < S;      // the same for the whole block
    if (more) {
      stage<DS>(sB[buf ^ 1], sC[buf ^ 1], Bm, Cm, row, t0 + kT, S);
      load(x, dt, xn, dn, row, t0 + kT, S, di, d, live);
    }
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      if (t0 + tt >= S) break;
      const float dtv = dc[tt];
      const float dx = dtv * xc[tt];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float dA = expf(dtv * a[s]);
        h[s] = h[s] * dA + dx * sB[buf][tt][s];
        acc += h[s] * sC[buf][tt][s];
      }
      if (live) y[(row + t0 + tt) * di + d] = acc;
    }
    __syncthreads();   // buffer `buf` read by all; `buf ^ 1` staged
    if (more) {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) {
        xc[tt] = xn[tt];
        dc[tt] = dn[tt];
      }
    }
  }

  if (live) {
    float* out = hout + (static_cast<size_t>(blockIdx.y) * di + d) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) out[s] = h[s];
  }
}

template <int DS>
cudaError_t launch(const float* x, const float* dt, const float* B,
                   const float* C, const float* A, float* y, float* h,
                   int batch, int S, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  selective_scan_fwd<DS><<<grid, kThreads, 0, stream>>>(x, dt, B, C, A, y, h,
                                                        S, di);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ds: 8, 16 or 32. The caller checks shapes, dtypes and contiguity.
int rt_selective_scan(const float* x, const float* dt, const float* B,
                      const float* C, const float* A, float* y, float* h,
                      int batch, int S, int di, int ds, void* stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || di <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 8:
      return static_cast<int>(launch<8>(x, dt, B, C, A, y, h, batch, S, di, s));
    case 16:
      return static_cast<int>(
          launch<16>(x, dt, B, C, A, y, h, batch, S, di, s));
    case 32:
      return static_cast<int>(
          launch<32>(x, dt, B, C, A, y, h, batch, S, di, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
