// Mamba1 selective scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../../_build.py).
//
// S1 selective_scan  <- repro/kernels/mamba_scan/kernel.py::selective_scan
//    (_scan_kernel). For every batch row b and channel d of d_inner, with
//    h_{-1} = 0:
//        h_t = exp(dt_t * A_d) * h_{t-1} + (dt_t * x_t) * B_t    (ds states)
//        y_t = sum_s h_t[s] * C_t[s]
//    x, dt and y are (b, S, di), B and C (b, S, ds), A (di, ds), all float32
//    and contiguous; h_final is (b, di, ds) float32. The arithmetic is the
//    reference's, per state: dA = expf(dt * A) (the accurate expf, no
//    fast-math), then h = h * dA + (dt * x) * B, written out as
//    __fmaf_rn(h, dA, (dt * x) * B) so that every build rounds the same
//    way. The sum for y runs over a lane's 4 states in increasing s, then
//    over a fixed xor tree of the channel's lanes (offsets 1, 2, 4). The
//    fused multiply-adds and this order of summation differ from the plain
//    version, so the two agree within 1e-4, not bit for bit.
//
//    Bound, at falcon-mamba-7b's prefill (b 4, S 512, di 8192, ds 16),
//    on an H100 SXM (132 SMs, 1.98 GHz):
//      - bytes: x, dt and y, 12 bytes per step and channel (B, C and A are
//        shared by every channel): 204,210,176 B, 0.0610 ms at 3.35 TB/s;
//      - exps: one per state and step, 268,435,456 MUFU.EX2 at 16 a clock
//        per SM (the SFU, not the FP32 pipes): 0.0642 ms;
//      - issue: the accurate expf is 8 instructions (one of them the
//        MUFU.EX2), so at one warp instruction a clock per scheduler the
//        exps alone already take the SFU's 0.0642 ms; dt * A, (dt * x) * B
//        and the FMAs into h and y add 4 a state and step, and a lane's
//        shared work (shared-memory loads, dt * x, the shuffles and the
//        store of y) about 2.5 more. The built step loop holds about 14.3
//        SASS instructions a state and step, an issue floor of about
//        0.115 ms (`chip_smoke.py` prints it from the SASS). Instruction
//        issue, not the bytes or the SFU, bounds this kernel; on an NVIDIA
//        H100 80GB HBM3 at 700 W it takes about 0.16 ms (PERF.md).
//
//    Design. The reference walks a sequential grid over chunks of S and
//    carries a (block_d, ds) state stripe in VMEM. On Hopper blocks run in
//    no order, so the loop over t runs inside the kernel and nothing is
//    carried between blocks. A block owns kCh = 64 channels of one batch
//    row. Each channel's ds states are split over G = ds / 4 adjacent
//    lanes (2, 4 or 8), each lane keeping 4 states and their 4 values of A
//    in registers from t = 0 to S-1: 16 * ds threads a block, 131,072
//    threads (31 warps an SM) at the main shape, against 32,768 with one
//    thread per channel. One state per lane would need a 16-lane shuffle
//    tree per step and double the instructions. Per step a lane reads its
//    channel's x_t and dt_t and its 4 values of B_t and C_t from shared
//    memory, and the channel's y_t goes through log2(G) __shfl_xor_sync,
//    issued after the next step's exps so that their latency overlaps.
//    x, dt, B and C are staged kT = 16 steps at a time by cp.async (16 B a
//    thread, contiguous along di), double-buffered: chunk n+1 is in
//    flight while chunk n computes. The group's first lane writes y_t into
//    a shared tile, and the block stores each chunk's y as 16 B vectors
//    while the next chunk computes. One barrier a chunk. Registers are
//    held to 64 a thread (__launch_bounds__), so an SM holds 32 warps:
//    the whole main-path grid in one wave. Tails in S and di are masked
//    (zero-filled copies, masked stores); any S >= 1 and di >= 1 are
//    taken. When di is not a multiple of 4 or a pointer is not 16-byte
//    aligned the copies and stores are 4 B a thread; the arithmetic is the
//    same code.
//
//    Each channel's result depends only on its own x, dt and A row and on
//    B and C of its batch row, through the same instructions in every
//    launch: a lane's bits do not depend on the batch it is launched in.
//
// The entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a launch that
// CUDA refused is reported by the caller.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCh = 64;      // channels per block
constexpr int kT = 16;       // steps staged per chunk
constexpr int kLaneStates = 4;   // states a lane keeps

// Threads a block: G = ds / 4 lanes for each of its kCh channels.
template <int DS>
constexpr int kThreadsFor = kCh * DS / kLaneStates;

// Blocks an SM must hold, so that 64 registers a thread is the cap.
template <int DS>
constexpr int kMinBlocksFor = 1024 / kThreadsFor<DS>;

template <int DS>
struct Smem {
  float x[2][kT][kCh];
  float dt[2][kT][kCh];
  float b[2][kT][DS];
  float c[2][kT][DS];
  float y[2][kT][kCh];
};

// cp.async of `bytes` (4 or 16) into shared memory; zeros when !ok (the
// source address is then not read).
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

// Calls f(i) for this thread's share of i in [0, N): i = threadIdx.x +
// r * THREADS, with a trip count fixed at compile time.
template <int N, int THREADS, typename F>
__device__ __forceinline__ void for_share(F&& f) {
#pragma unroll
  for (int r = 0; r < (N + THREADS - 1) / THREADS; ++r) {
    const int i = static_cast<int>(threadIdx.x) + r * THREADS;
    if (N % THREADS == 0 || i < N) f(i);
  }
}

// x and dt of the block's channels and B and C of steps [t0, t0 + kT) of
// batch row `row` (its first step) into buffer `buf`, zeros past S and di;
// one commit group. VEC: 16 B copies (di % 4 == 0, aligned pointers).
template <int DS, bool VEC>
__device__ __forceinline__ void stage(Smem<DS>& sm, int buf,
                                      const float* __restrict__ x,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ Bm,
                                      const float* __restrict__ Cm,
                                      size_t row, int t0, int S, int di,
                                      int d0) {
  constexpr int W = VEC ? 4 : 1;          // floats a copy
  constexpr int kXV = kCh / W, kBV = DS / W;
  const size_t at = (row + t0) * di + d0; // the chunk's first x element
  for_share<kT * kXV, kThreadsFor<DS>>([&](int i) {
    const int tt = i / kXV, c = (i % kXV) * W;
    const bool ok = t0 + tt < S && d0 + c < di;  // VEC: all in or all out
    const size_t o = ok ? at + static_cast<size_t>(tt) * di + c : 0;
    copy_async<4 * W>(&sm.x[buf][tt][c], x + o, ok);
    copy_async<4 * W>(&sm.dt[buf][tt][c], dt + o, ok);
  });
  for_share<kT * kBV, kThreadsFor<DS>>([&](int i) {
    const int tt = i / kBV, s = (i % kBV) * W;
    const bool ok = t0 + tt < S;
    const size_t o = ok ? (row + t0 + tt) * DS + s : 0;
    copy_async<4 * W>(&sm.b[buf][tt][s], Bm + o, ok);
    copy_async<4 * W>(&sm.c[buf][tt][s], Cm + o, ok);
  });
  asm volatile("cp.async.commit_group;\n" ::);
}

// y of steps [t0, t0 + kT) from buffer `buf` to device memory, masked.
template <int DS, bool VEC>
__device__ __forceinline__ void store_y(const Smem<DS>& sm, int buf,
                                        float* __restrict__ y, size_t row,
                                        int t0, int S, int di, int d0) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int kV = kCh / W;
  float* out = y + (row + t0) * di + d0;
  for_share<kT * kV, kThreadsFor<DS>>([&](int i) {
    const int tt = i / kV, c = (i % kV) * W;
    if (t0 + tt >= S || d0 + c >= di) return;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(tt) * di + c) =
          *reinterpret_cast<const float4*>(&sm.y[buf][tt][c]);
    } else {
      out[static_cast<size_t>(tt) * di + c] = sm.y[buf][tt][c];
    }
  });
}

// y_{tt} of channel c, summed over the group's lanes by the xor tree, into
// the buffer's y tile by the group's first lane.
template <int DS>
__device__ __forceinline__ void finish_y(Smem<DS>& sm, int buf, int tt,
                                         int c, int lane, float acc) {
#pragma unroll
  for (int off = 1; off < DS / kLaneStates; off <<= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) sm.y[buf][tt][c] = acc;
}

// The recurrence over the first n steps of buffer `buf` (n = kT if FULL)
// for channel c's states [4 * lane, 4 * lane + 4). A step's partial sum
// for y goes through the shuffles after the next step's exps are issued,
// so that their latency overlaps. Every lane of the warp runs it.
template <int DS, bool FULL>
__device__ __forceinline__ void run_steps(Smem<DS>& sm, int buf, int c,
                                          int lane,
                                          const float (&a)[kLaneStates],
                                          float (&h)[kLaneStates], int n) {
  float pend = 0.f;                       // step tt - 1's partial y
#pragma unroll
  for (int tt = 0; tt < kT; ++tt) {
    if (!FULL && tt >= n) break;          // the same for the whole block
    const float dtv = sm.dt[buf][tt][c];
    const float dx = __fmul_rn(dtv, sm.x[buf][tt][c]);
    const float4 bv =
        *reinterpret_cast<const float4*>(&sm.b[buf][tt][kLaneStates * lane]);
    const float4 cv =
        *reinterpret_cast<const float4*>(&sm.c[buf][tt][kLaneStates * lane]);
    const float bs[kLaneStates] = {bv.x, bv.y, bv.z, bv.w};
    const float cs[kLaneStates] = {cv.x, cv.y, cv.z, cv.w};
    float dA[kLaneStates];
#pragma unroll
    for (int j = 0; j < kLaneStates; ++j)
      dA[j] = expf(__fmul_rn(dtv, a[j]));
    if (tt > 0) finish_y<DS>(sm, buf, tt - 1, c, lane, pend);
#pragma unroll
    for (int j = 0; j < kLaneStates; ++j) {
      h[j] = __fmaf_rn(h[j], dA[j], __fmul_rn(dx, bs[j]));
      pend = j == 0 ? __fmul_rn(h[j], cs[j]) : __fmaf_rn(h[j], cs[j], pend);
    }
  }
  finish_y<DS>(sm, buf, (FULL ? kT : n) - 1, c, lane, pend);
}

template <int DS, bool VEC>
__global__ void __launch_bounds__(kThreadsFor<DS>, kMinBlocksFor<DS>)
selective_scan_fwd(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, float* __restrict__ y,
                   float* __restrict__ hout, int S, int di) {
  constexpr int G = DS / kLaneStates;
  __shared__ __align__(16) Smem<DS> sm;

  const int lane = threadIdx.x % G;       // states [4 * lane, 4 * lane + 4)
  const int c = threadIdx.x / G;          // the block's channel
  const int d0 = blockIdx.x * kCh, d = d0 + c;
  const bool live = d < di;
  const size_t row = static_cast<size_t>(blockIdx.y) * S;   // first step

  float a[kLaneStates], h[kLaneStates];
#pragma unroll
  for (int j = 0; j < kLaneStates; ++j) {
    a[j] = live ? A[static_cast<size_t>(d) * DS + kLaneStates * lane + j]
                : 0.f;
    h[j] = 0.f;
  }

  const int chunks = (S + kT - 1) / kT;
  stage<DS, VEC>(sm, 0, x, dt, Bm, Cm, row, 0, S, di, d0);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * kT;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk k has landed for every thread; chunk k-1 is computed, so its
    // y tile is whole and its input buffer, buf ^ 1, is free
    __syncthreads();
    if (k > 0) store_y<DS, VEC>(sm, buf ^ 1, y, row, t0 - kT, S, di, d0);
    if (k + 1 < chunks)
      stage<DS, VEC>(sm, buf ^ 1, x, dt, Bm, Cm, row, t0 + kT, S, di, d0);
    const int n = S - t0;
    if (n >= kT)
      run_steps<DS, true>(sm, buf, c, lane, a, h, kT);
    else
      run_steps<DS, false>(sm, buf, c, lane, a, h, n);
  }
  __syncthreads();
  store_y<DS, VEC>(sm, (chunks - 1) & 1, y, row, (chunks - 1) * kT, S, di,
                   d0);

  if (live) {
    float* out = hout + (static_cast<size_t>(blockIdx.y) * di + d) * DS +
                 kLaneStates * lane;
#pragma unroll
    for (int j = 0; j < kLaneStates; ++j) out[j] = h[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <int DS, bool VEC>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&selective_scan_fwd<DS, VEC>);
}

template <int DS>
cudaError_t launch(const float* x, const float* dt, const float* B,
                   const float* C, const float* A, float* y, float* h,
                   int batch, int S, int di, cudaStream_t stream) {
  const dim3 grid((di + kCh - 1) / kCh, batch);
  constexpr int kThreads = kThreadsFor<DS>;
  if (di % 4 == 0 && aligned16(x) && aligned16(dt) && aligned16(B) &&
      aligned16(C) && aligned16(y))
    selective_scan_fwd<DS, true><<<grid, kThreads, 0, stream>>>(
        x, dt, B, C, A, y, h, S, di);
  else
    selective_scan_fwd<DS, false><<<grid, kThreads, 0, stream>>>(
        x, dt, B, C, A, y, h, S, di);
  return cudaGetLastError();
}

template <int DS>
cudaError_t occupancy(int vec, int* regs, int* warps) {
  const void* fn = vec ? kernel_fn<DS, true>() : kernel_fn<DS, false>();
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                    kThreadsFor<DS>, 0);
  *regs = attr.numRegs;
  *warps = blocks * kThreadsFor<DS> / 32;
  return e;
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

// Registers a thread and resident warps an SM of the kernel for state size
// ds, with 16 B copies (vec != 0) or 4 B ones, on the current device.
int rt_selective_scan_occupancy(int ds, int vec, int* regs, int* warps) {
  switch (ds) {
    case 8: return static_cast<int>(occupancy<8>(vec, regs, warps));
    case 16: return static_cast<int>(occupancy<16>(vec, regs, warps));
    case 32: return static_cast<int>(occupancy<32>(vec, regs, warps));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
