// Selective-scan (Mamba) kernel for Hopper (sm_90a): a chunked two-pass
// scan with each thread's states in registers.
//
// Replaces the Pallas TPU kernel `selective_scan` / `_sscan_kernel` in
// src/repro/kernels/selective_scan.py:67.  x, delta (B, L, di); b_sel, c_sel
// (B, L, N); a_log (di, N) f32  ->  y (B, L, di) in x's dtype:
//   A = -exp(a_log),  h_t = exp(delta_t A) * h_{t-1} + delta_t B_t x_t,
//   y_t = <h_t, C_t>,  h_0 = 0 (or the caller's h0), all arithmetic in f32.
// Optionally it starts from an initial state h0 (B, di, N) f32 (the frozen
// prefix's end state: the reference's mamba_forward(state=...)) and writes
// the exact end state h_L (B, di, N) f32 (its return_state=True, which the
// reference gets from selective_last_state; no padded step ever enters it
// here, since chunks stop at L).
// x, delta, b_sel and c_sel are each f32 or bf16 (a flag per input: on the
// serving path x is bf16 while delta, B and C are f32).
//
// Bound: at N = 16 the exps, not the bytes.  The function needs one exp
// per (b, t, channel, n), B*L*di*N of them (~13 M at B=2, L=128,
// di=3200), on the SFU at 16 per clock per SM; its bytes are x, delta, B,
// C and a_log read once and y written once (~6.8 MB there, independent of
// N).  This design computes every decay twice, once in each pass, so its
// own exp floor is 2*B*L*di*N exps: twice that bound.  The price buys
// parallelism over L without a block-wide scan.  The (B, L, di, N) decay
// and drive tensors never touch device memory.
//
// Design.  A GPU grid has no order, so the Pallas kernel's carry of h
// across time tiles becomes a chunked scan with a carry fold, the scheme
// of the reference model's own scan (src/repro/models/ssm.py:383-401).
// The wrapper (kernels/selective_scan.py:chunk_len) cuts L into nch
// chunks of Tc steps: enough chunks for about 51,200 threads in all
// (three 128-thread blocks on each of the 132 SMs), at most 16 of them
// and each of at least 16 steps, the last one shorter where L is ragged.
// One thread owns one (row b, channel c, chunk j) and holds all N states
// of its channel in registers (h[NP], NP = N rounded up to a power of
// two, at least 4; states n >= N have A = 0 and B = C = 0, so they stay
// 0).  A block of 128 threads takes 128 consecutive channels of one
// (b, j): it stages kStage steps at a time of its channels' x and delta
// (coalesced loads) and of the row's B and C (shared by every channel;
// read back as broadcasts) in shared memory as f32.  Every global load is
// unconditional, on clamped indices, so a thread has a whole stage's
// loads in flight before it waits on any (a load under a branch costs
// one memory round trip each).
//   Pass 1 (chunks 0 .. nch-2): walk the chunk from h = 0 with the exact
//     per-step arithmetic, keeping the running product P_n of the decays
//     it computes anyway; write h_end and P to the f32 workspace
//     (2, B, nch-1, N, di).  No y.
//   Pass 2 (every chunk): fold the carries of chunks 0 .. j-1 into h0 (0
//     without one), H = P_i * H + h_end_i (no exp; pass 1 never reads h0,
//     its chunks start from 0), then walk the chunk again from H
//     with the exact sequential recurrence; y_t = sum_n h_n C_{t,n} is
//     summed in registers (no shuffles) and written in x's dtype.  It is
//     launched as pass 1's programmatic dependent (PDL): its blocks start
//     as pass 1's blocks leave room and wait for pass 1's writes
//     (griddepcontrol.wait) only before the fold; chunk 0 has no fold.
//     The last chunk's threads write their end state to h_out when asked.
// A serving call (B=2, L=128, di=3200) runs 25 * 8 * 2 blocks in pass 2,
// a (1, 2048, 3200) call 25 * 16.  Ragged L and di are masked: a chunk
// stops at L, and lanes past di compute on channel di-1 and write
// nothing.  No atomics and a fixed fold order: equal inputs give equal
// bits.  Built without --use_fast_math: expf stays the accurate one.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kStage = 16;      // time steps staged in shared memory at once

struct Args {
  const void* x;
  const void* delta;
  const void* bsel;
  const void* csel;
  const float* a_log;
  float* ws;                    // h_end then P, each (B, nch - 1, N, di)
  void* y;
  const float* h0;              // (B, di, N) initial state, or null (zeros)
  float* h_out;                 // (B, di, N) end state, or null
  int B, L, di, N, chunk, nch;
  int x_bf16, d_bf16, b_bf16, c_bf16;
};

// r[k] = p[base + off(k)] as f32.  Every load is unconditional (callers
// clamp the offsets into bounds and mask the values), and the dtype branch
// sits outside the unrolled loop, so a thread has all K loads in flight
// at once instead of one round trip per load.
template <int K, typename Off>
__device__ __forceinline__ void gather(float (&r)[K], const void* p,
                                       long long base, Off off, int bf16) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + base;
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = __bfloat162float(q[off(k)]);
  } else {
    const float* q = static_cast<const float*>(p) + base;
#pragma unroll
    for (int k = 0; k < K; ++k) r[k] = q[off(k)];
  }
}

// kOut false: pass 1 (chunk states).  kOut true: pass 2 (fold, then y).
// Pass 2 is launched as pass 1's programmatic dependent: its blocks may
// start while pass 1 runs, and wait for it (griddepcontrol.wait) only
// before they read the workspace, which chunk 0 never does.
template <int NP, bool kOut>
__global__ void __launch_bounds__(kThreads) sscan_chunk_kernel(const Args g) {
  __shared__ float s_x[kStage][kThreads];
  __shared__ float s_d[kStage][kThreads];
  __shared__ __align__(16) float s_b[kStage][NP];
  __shared__ __align__(16) float s_c[kOut ? kStage : 1][NP];

  if constexpr (!kOut) asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = c < g.di;
  const int cc = min(c, g.di - 1);        // lanes past di read channel di-1
  const int t_end = min(g.L, (j + 1) * g.chunk);
  const long long row0 = static_cast<long long>(b) * g.L;
  const long long plane =
      static_cast<long long>(g.B) * (g.nch - 1) * g.N * g.di;

  float a[NP], h[NP], p[NP];                 // a_log's loads overlap the fold
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    a[n] = g.a_log[static_cast<long long>(cc) * g.N + min(n, g.N - 1)];
    h[n] = 0.f;
    p[n] = 1.f;
  }
  if constexpr (kOut) {
    if (g.h0) {                              // the fold starts from h0
      const float* h0 = g.h0 + (static_cast<long long>(b) * g.di + cc) * g.N;
#pragma unroll
      for (int n = 0; n < NP; ++n) h[n] = n < g.N ? h0[min(n, g.N - 1)] : 0.f;
    }
    if (j > 0) asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int i = 0; i < j; ++i) {            // H = P_i * H + h_end_i
      const long long base =
          static_cast<long long>(b * (g.nch - 1) + i) * g.N * g.di + cc;
      float pv[NP], hv[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const long long k =
            base + static_cast<long long>(min(n, g.N - 1)) * g.di;
        pv[n] = g.ws[plane + k];
        hv[n] = g.ws[k];
      }
#pragma unroll
      for (int n = 0; n < NP; ++n)
        h[n] = n < g.N ? pv[n] * h[n] + hv[n] : 0.f;
    }
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) a[n] = n < g.N ? -expf(a[n]) : 0.f;

  for (int t0 = j * g.chunk; t0 < t_end; t0 += kStage) {
    const int T = min(kStage, t_end - t0);
    // x and delta of this thread's channel for T steps (rows past T repeat
    // the last one and are never read), and B and C of the row for T
    // steps x NP states (states n >= N are zero)
    constexpr int kBC = (kStage * NP + kThreads - 1) / kThreads;
    const long long xbase = (row0 + t0) * g.di + cc;
    const long long bbase = (row0 + t0) * g.N;
    const auto xoff = [&](int tt) { return min(tt, T - 1) * g.di; };
    const auto boff = [&](int k) {
      const int e = k * kThreads + threadIdx.x;
      return min(e / NP, T - 1) * g.N + min(e % NP, g.N - 1);
    };
    float xv[kStage], dv[kStage], bv[kBC], cv[kBC];
    gather(xv, g.x, xbase, xoff, g.x_bf16);
    gather(dv, g.delta, xbase, xoff, g.d_bf16);
    gather(bv, g.bsel, bbase, boff, g.b_bf16);
    if constexpr (kOut) gather(cv, g.csel, bbase, boff, g.c_bf16);
#pragma unroll
    for (int tt = 0; tt < kStage; ++tt) {
      s_x[tt][threadIdx.x] = xv[tt];
      s_d[tt][threadIdx.x] = dv[tt];
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int e = k * kThreads + threadIdx.x;
      if (e < kStage * NP) {
        const bool in = e % NP < g.N;
        s_b[e / NP][e % NP] = in ? bv[k] : 0.f;
        if constexpr (kOut) s_c[e / NP][e % NP] = in ? cv[k] : 0.f;
      }
    }
    __syncthreads();

    for (int tt = 0; tt < T; ++tt) {
      const float dt = s_d[tt][threadIdx.x];
      const float x = s_x[tt][threadIdx.x];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const float decay = expf(dt * a[n]);
        h[n] = decay * h[n] + dt * s_b[tt][n] * x;
        if constexpr (kOut)
          acc += h[n] * s_c[tt][n];
        else
          p[n] *= decay;
      }
      if (kOut && live) {
        const long long gi = (row0 + t0 + tt) * g.di + c;
        if (g.x_bf16)
          static_cast<__nv_bfloat16*>(g.y)[gi] = __float2bfloat16(acc);
        else
          static_cast<float*>(g.y)[gi] = acc;
      }
    }
    __syncthreads();                          // the next stage restages
  }

  if (kOut && live && g.h_out && j == g.nch - 1) {
    float* out = g.h_out + (static_cast<long long>(b) * g.di + c) * g.N;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < g.N) out[n] = h[n];
  }
  if (!kOut && live) {
    const long long base =
        static_cast<long long>(b * (g.nch - 1) + j) * g.N * g.di + c;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < g.N) {
        const long long k = base + static_cast<long long>(n) * g.di;
        g.ws[k] = h[n];
        g.ws[plane + k] = p[n];
      }
  }
}

template <int NP>
int launch(const Args& g, cudaStream_t stream) {
  const int cx = (g.di + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cx, g.nch, g.B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  if (g.nch > 1) {
    sscan_chunk_kernel<NP, false>
        <<<dim3(cx, g.nch - 1, g.B), kThreads, 0, stream>>>(g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.attrs = pdl;                          // pass 2 may overlap pass 1
    cfg.numAttrs = 1;
  }
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, sscan_chunk_kernel<NP, true>, g));
}

}  // namespace

// Two launches on `stream` (pass 1 only when L spans more than one chunk).
// Returns the first failing launch's cudaError_t, 0 on success.  N must be
// in [1, 32], B below 65536, chunk >= 1; every tensor contiguous; a_log
// f32; ws f32 with room for 2 * B * (ceil(L / chunk) - 1) * N * di floats;
// h0 (the initial state) and h_out (the end state), each (B, di, N) f32,
// may be null.
extern "C" int repro_selective_scan(const void* x, const void* delta,
                                    const void* bsel, const void* csel,
                                    const void* a_log, void* ws, void* y,
                                    const void* h0, void* h_out,
                                    int B, int L, int di, int N, int chunk,
                                    int x_bf16, int d_bf16, int b_bf16,
                                    int c_bf16, void* stream) {
  if (chunk < 1 || N < 1 || N > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{x, delta, bsel, csel, static_cast<const float*>(a_log),
               static_cast<float*>(ws), y, static_cast<const float*>(h0),
               static_cast<float*>(h_out), B, L, di, N, chunk,
               (L + chunk - 1) / chunk, x_bf16, d_bf16, b_bf16, c_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4>(g, s);
  if (N <= 8) return launch<8>(g, s);
  if (N <= 16) return launch<16>(g, s);
  return launch<32>(g, s);
}
