// Fused selective-scan (Mamba) kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `selective_scan` / `_sscan_kernel` in
// src/repro/kernels/selective_scan.py.  x, delta (B, L, di); b_sel, c_sel
// (B, L, N); a_log (di, N) f32 ->  y (B, L, di) in x's dtype:
//   A = -exp(a_log),  h_t = exp(delta_t A) * h_{t-1} + delta_t B_t x_t,
//   y_t = <h_t, C_t>,  h_0 = 0, all arithmetic in f32.
// x, delta, b_sel and c_sel are each f32 or bf16 (a flag per input: on the
// serving path x is bf16 while delta, B and C are f32).
//
// Bound: at N = 16 the exps, not the bytes.  Every (b, t, channel, n)
// needs one exp (B*L*di*N of them, ~13 M at B=2, L=128, di=3200) on the
// SFU, 16 per clock per SM; the bytes are x, delta, B, C and a_log read
// once and y written once (~6.8 MB there, independent of N).  The decay
// and drive tensors, (B, L, di, N), never touch device memory: they live
// one step at a time in registers.
//
// Design.  A GPU grid has no order, so the Pallas kernel's carry of h
// across time tiles (VMEM scratch) becomes a loop over t inside each block
// with h in a register.  One lane per (b, channel, n): a warp holds 32/NP
// channels (NP = N rounded up to a power of two, at least 4; lanes with
// n >= N hold zeros), and y_t is reduced over the NP lanes of a channel by
// warp shuffles.  A block of 128 threads owns 128/NP channels of one batch
// row (grid: channel groups x batch).  Per chunk of kChunk time steps the
// block stages x and delta of its channels and B and C of the row (shared
// by every channel) in shared memory as f32, runs the recurrence out of
// shared memory, and writes the chunk's y back from shared memory.  Ragged
// L and di are masked: padded steps and channels read zeros and are not
// written.  Built without --use_fast_math: expf stays the accurate one.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
sscan_kernel(const void* __restrict__ x, const void* __restrict__ delta,
             const void* __restrict__ bsel, const void* __restrict__ csel,
             const float* __restrict__ a_log, void* __restrict__ y,
             int L, int di, int N, int x_bf16, int d_bf16, int b_bf16,
             int c_bf16) {
  constexpr int CH = kThreads / NP;           // channels per block
  __shared__ float s_x[kChunk][CH];
  __shared__ float s_d[kChunk][CH];
  __shared__ float s_y[kChunk][CH];
  __shared__ float s_b[kChunk][NP];
  __shared__ float s_c[kChunk][NP];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int lc = threadIdx.x / NP;            // channel within the block
  const int n = threadIdx.x % NP;
  const int c = c0 + lc;
  const float a = (c < di && n < N) ? -expf(a_log[(long long)c * N + n])
                                    : 0.f;
  const long long row0 = (long long)b * L;
  float h = 0.f;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int T = min(kChunk, L - t0);
    for (int e = threadIdx.x; e < kChunk * CH; e += kThreads) {
      const int tt = e / CH, cc = e % CH;
      float xv = 0.f, dv = 0.f;
      if (tt < T && c0 + cc < di) {
        const long long gi = (row0 + t0 + tt) * di + c0 + cc;
        xv = load(x, gi, x_bf16);
        dv = load(delta, gi, d_bf16);
      }
      s_x[tt][cc] = xv;
      s_d[tt][cc] = dv;
    }
    for (int e = threadIdx.x; e < kChunk * NP; e += kThreads) {
      const int tt = e / NP, nn = e % NP;
      float bv = 0.f, cv = 0.f;
      if (tt < T && nn < N) {
        const long long gi = (row0 + t0 + tt) * N + nn;
        bv = load(bsel, gi, b_bf16);
        cv = load(csel, gi, c_bf16);
      }
      s_b[tt][nn] = bv;
      s_c[tt][nn] = cv;
    }
    __syncthreads();

    // T is uniform across the block, so every lane of a warp takes part
    // in each shuffle.
    for (int tt = 0; tt < T; ++tt) {
      const float dt = s_d[tt][lc];
      const float decay = expf(dt * a);
      const float drive = dt * s_b[tt][n] * s_x[tt][lc];
      h = decay * h + drive;
      float p = h * s_c[tt][n];
#pragma unroll
      for (int off = NP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) s_y[tt][lc] = p;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < T * CH; e += kThreads) {
      const int tt = e / CH, cc = e % CH;
      if (c0 + cc < di) {
        const long long gi = (row0 + t0 + tt) * di + c0 + cc;
        if (x_bf16)
          static_cast<__nv_bfloat16*>(y)[gi] = __float2bfloat16(s_y[tt][cc]);
        else
          static_cast<float*>(y)[gi] = s_y[tt][cc];
      }
    }
    __syncthreads();                          // the next chunk restages
  }
}

template <int NP>
void launch(const void* x, const void* delta, const void* bsel,
            const void* csel, const float* a_log, void* y, int B, int L,
            int di, int N, int x_bf16, int d_bf16, int b_bf16, int c_bf16,
            cudaStream_t stream) {
  constexpr int CH = kThreads / NP;
  const dim3 grid((di + CH - 1) / CH, B);
  sscan_kernel<NP><<<grid, kThreads, 0, stream>>>(
      x, delta, bsel, csel, a_log, y, L, di, N, x_bf16, d_bf16, b_bf16,
      c_bf16);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  N must be in [1, 32],
// B below 65536; every tensor contiguous; a_log f32.
extern "C" int repro_selective_scan(const void* x, const void* delta,
                                    const void* bsel, const void* csel,
                                    const void* a_log, void* y, int B, int L,
                                    int di, int N, int x_bf16, int d_bf16,
                                    int b_bf16, int c_bf16, void* stream) {
  const float* a = static_cast<const float*>(a_log);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4)
    launch<4>(x, delta, bsel, csel, a, y, B, L, di, N, x_bf16, d_bf16, b_bf16,
              c_bf16, s);
  else if (N <= 8)
    launch<8>(x, delta, bsel, csel, a, y, B, L, di, N, x_bf16, d_bf16, b_bf16,
              c_bf16, s);
  else if (N <= 16)
    launch<16>(x, delta, bsel, csel, a, y, B, L, di, N, x_bf16, d_bf16,
               b_bf16, c_bf16, s);
  else
    launch<32>(x, delta, bsel, csel, a, y, B, L, di, N, x_bf16, d_bf16,
               b_bf16, c_bf16, s);
  return static_cast<int>(cudaGetLastError());
}
