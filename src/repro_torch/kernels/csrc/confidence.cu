// Fused decode-confidence kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `confidence_fused` / `_confidence_kernel`
// in src/repro/kernels/confidence.py.  Logits (rows, V), f32 or bf16, ->
// per row: argmax (int32), max prob, top-2 margin and sum_v p log p, in one
// pass over the vocab, from the online accumulators
//   m (running max), s = sum exp(l - m), u = sum l exp(l - m),
//   m2 (second largest logit; equal to m when the max occurs twice),
//   i1 (argmax; the lowest index among equal maxima, as jnp.argmax).
//
// Bound: device-memory bytes.  Each logit is read once and takes about
// five float operations, so the arithmetic intensity is ~1 op/byte for
// f32, far below the card's ridge; the least time is rows*V*sizeof(T) over
// the memory rate.  Design: one CTA per row, 256 threads striding the
// vocab with 16-byte vector loads (coalesced: neighbouring threads read
// neighbouring 16-byte chunks), per-thread accumulators in registers, then
// a warp-shuffle merge and a shared-memory merge across the 8 warps.  No
// intermediate touches device memory.  At the decode shapes (hundreds of
// rows, V = 126464) one CTA per row fills the 132 SMs; splitting V across
// CTAs for few-row calls is later work.
//
// Built without --use_fast_math: the accumulators start at -3.4e38 and
// s * exp(m_old - m_new) must give exactly 0 there, not NaN.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.4e38f;

struct Acc {
  float m, s, u, m2;
  int i1;
};

__device__ __forceinline__ void init(Acc& a) {
  a.m = kNeg; a.s = 0.f; a.u = 0.f; a.m2 = kNeg; a.i1 = 0;
}

// One element l at vocab index j; j increases along a thread's stream, so
// keeping the old argmax on l == m keeps the lowest index.
__device__ __forceinline__ void push(Acc& a, float l, int j) {
  if (l > a.m) {
    const float alpha = expf(a.m - l);
    a.s = a.s * alpha + 1.f;
    a.u = a.u * alpha + l;
    a.m2 = a.m;
    a.m = l;
    a.i1 = j;
  } else {
    if (l > a.m2) a.m2 = l;          // l == m: duplicated max -> m2 = m
    const float e = expf(l - a.m);
    a.s += e;
    if (e > 0.f) a.u += l * e;
  }
}

// Merge partial b into a.  Equal maxima from two partials give m2 = m
// (margin exactly 0) and keep the lower argmax index.
__device__ __forceinline__ void merge(Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  const float ea = expf(a.m - m), eb = expf(b.m - m);
  const float s = a.s * ea + b.s * eb;
  const float u = (a.s > 0.f ? a.u * ea : 0.f) + (b.s > 0.f ? b.u * eb : 0.f);
  float m2;
  int i1;
  if (a.m > b.m) {
    m2 = fmaxf(a.m2, b.m); i1 = a.i1;
  } else if (b.m > a.m) {
    m2 = fmaxf(b.m2, a.m); i1 = b.i1;
  } else {
    m2 = m; i1 = min(a.i1, b.i1);
  }
  a.m = m; a.s = s; a.u = u; a.m2 = m2; a.i1 = i1;
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int off) {
  Acc b;
  b.m = __shfl_down_sync(0xffffffffu, a.m, off);
  b.s = __shfl_down_sync(0xffffffffu, a.s, off);
  b.u = __shfl_down_sync(0xffffffffu, a.u, off);
  b.m2 = __shfl_down_sync(0xffffffffu, a.m2, off);
  b.i1 = __shfl_down_sync(0xffffffffu, a.i1, off);
  return b;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;               // 4 x f32 = 16 bytes
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float one(const float* p) { return *p; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;               // 8 x bf16 = 16 bytes
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
confidence_kernel(const T* __restrict__ logits, int vocab,
                  int32_t* __restrict__ argmax, float* __restrict__ maxp,
                  float* __restrict__ margin, float* __restrict__ negent) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<int64_t>(row) * vocab;
  Acc acc;
  init(acc);
  if (kVector) {
    constexpr int N = Vec<T>::N;
    const int chunks = vocab / N;           // vocab % N == 0 on this path
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float v[N];
      Vec<T>::load(x + static_cast<int64_t>(c) * N, v);
#pragma unroll
      for (int e = 0; e < N; ++e) push(acc, v[e], c * N + e);
    }
  } else {
    for (int j = threadIdx.x; j < vocab; j += kThreads) {
      push(acc, Vec<T>::one(x + j), j);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(acc, shfl_down(acc, off));

  __shared__ Acc part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) acc = part[lane]; else init(acc);
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      merge(acc, shfl_down(acc, off));
    }
    if (lane == 0) {
      const float inv_s = 1.f / acc.s;
      const float p2 = expf(acc.m2 - acc.m) * inv_s;
      argmax[row] = acc.i1;
      maxp[row] = inv_s;
      margin[row] = inv_s - p2;
      negent[row] = acc.u * inv_s - (acc.m + logf(acc.s));
    }
  }
}

template <typename T>
cudaError_t launch(const void* logits, int rows, int vocab, void* argmax,
                   void* maxp, void* margin, void* negent,
                   cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(logits) % 16 == 0) &&
      (vocab % Vec<T>::N == 0);
  const dim3 grid(rows), block(kThreads);
  const T* x = static_cast<const T*>(logits);
  int32_t* a = static_cast<int32_t*>(argmax);
  float* p = static_cast<float*>(maxp);
  float* mg = static_cast<float*>(margin);
  float* ne = static_cast<float*>(negent);
  if (aligned) {
    confidence_kernel<T, true><<<grid, block, 0, stream>>>(x, vocab, a, p,
                                                           mg, ne);
  } else {
    confidence_kernel<T, false><<<grid, block, 0, stream>>>(x, vocab, a, p,
                                                            mg, ne);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int repro_confidence(const void* logits, int rows, int vocab,
                                int dtype, void* argmax, void* maxp,
                                void* margin, void* negent, void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(logits, rows, vocab, argmax, maxp, margin, negent, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(logits, rows, vocab, argmax, maxp, margin,
                                negent, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
