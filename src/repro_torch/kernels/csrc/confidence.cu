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
// Bound: device-memory bytes.  Each logit is read once and takes about a
// dozen instructions (five compares and selects for the top two and the
// argmax; subtract, multiply and ex2 for the exp; add, clamp and FMA for s
// and u), ~3 per byte in f32 and ~6 in bf16, below the card's ridge; the
// least time is rows*V*sizeof(T) over the memory rate.
//
// Design: one CTA of 256 threads per row, one kernel per dtype.  A row is
// cut into three parts, reckoned from the row's own address (so a
// misaligned base pointer or a V that is not a multiple of the vector
// width, Hymba's V = 32001, keeps the vector loads):
//   head  — from the row's start up to its first 16-byte boundary (at most
//           3 f32 or 7 bf16 logits), one logit each for the first threads;
//   body  — whole 16-byte chunks.  In each step every thread issues
//           kLoads = 4 unconditional streaming (evict-first) vector loads,
//           at chunks c0 + k*256 (k = 0..3; coalesced: neighbouring threads
//           read neighbouring chunks), before it folds any of them, so a
//           256-row call keeps ~32 KB in flight per SM.  Only the last,
//           partial step clamps its chunk indices and masks the surplus
//           values to -inf;
//   tail  — the rest, fewer than one chunk, one logit each for the first
//           threads.
// A thread's indices rise along its stream (head, body steps, tail).  Each
// body step is folded as one group of 16 f32 or 32 bf16 values: its top
// two and the first index of its maximum by comparisons alone, a rescale
// of (s, u) only where the running max rises (one exp per group), then the
// group's exps added without branches.  The exps are ex2.approx of
// (l - m)*log2(e); a -inf logit adds exactly 0 to s and, through
// max(l, -3.4e38)*0, to u.  Equal maxima keep the first (lowest) index in
// a thread and give m2 = m; `merge` keeps that across threads.  Then a
// warp-shuffle merge and a shared-memory merge across the 8 warps.  No
// intermediate touches device memory.
//
// The vocab is not split across CTAs: at the serving path's row counts
// (224-512 rows: batches are padded to max_batch) one split measured
// faster than two (0.0902 against 0.0935 ms at 512 x 126464 f32, 0.0188
// against 0.0204 at 256 x 32001 on an H100); two won only at 128 rows.
// The split waits for the cached path, whose window queries make few-row
// calls.
//
// The partials variant (kPartials = true, `repro_confidence_partials`)
// serves a vocab split across ranks: the same loads, fold and merges,
// but its epilogue writes the row's accumulators (m, s, u, m2 and i1
// plus the shard's first vocab id) instead of the four scores, for
// `core/confidence.py:score_logits_sharded` to gather and merge.  It
// replaces no Pallas kernel of its own: the reference reaches the same
// per-shard reductions through GSPMD's partitioning of
// `score_logits_sharded`'s axis reductions.
//
// Built without --use_fast_math: the accumulators start at -3.4e38 and
// s * exp(m_old - m_new) must give exactly 0 there, not NaN.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// The cut, fold and merge trees at these values are emulated in plain
// torch by tests/test_torch_kernels.py::test_confidence_cta_* (thread
// count and loads per step as parameters).
constexpr int kThreads = 256;
constexpr int kLoads = 4;                 // 16-byte loads in flight per thread
constexpr int kMinBlocks = 4;             // CTAs per SM: <= 64 registers
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.4e38f;
constexpr float kLog2e = 1.4426950408889634f;

struct Acc {
  float m, s, u, m2;
  int i1;
};

__device__ __forceinline__ void init(Acc& a) {
  a.m = kNeg; a.s = 0.f; a.u = 0.f; a.m2 = kNeg; a.i1 = 0;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fold one group of K x NV values, in rising index order, into a.  The
// value at v[k * NV + e] has vocab index base + k * kStride + e; masked
// values are -inf.
template <int K, int NV, int kStride>
__device__ __forceinline__ void fold(Acc& a, const float (&v)[K * NV],
                                     int base) {
  float gm = -INFINITY, g2 = -INFINITY;
  int gi = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const float l = v[k * NV + e];
      g2 = fmaxf(g2, fminf(gm, l));       // a repeated max gives g2 = gm
      gi = l > gm ? k * kStride + e : gi; // first index of the max
      gm = fmaxf(gm, l);
    }
  }
  if (gm > a.m) {                         // the running max rises
    const float alpha = ex2((a.m - gm) * kLog2e);
    a.s *= alpha;
    a.u *= alpha;
    a.m2 = fmaxf(a.m, g2);
    a.m = gm;
    a.i1 = base + gi;
  } else {
    a.m2 = fmaxf(a.m2, gm);               // gm == m: tied max, m2 = m
  }
#pragma unroll
  for (int j = 0; j < K * NV; ++j) {
    const float e = ex2((v[j] - a.m) * kLog2e);
    a.s += e;
    a.u = fmaf(fmaxf(v[j], kNeg), e, a.u);  // -inf * 0 would be NaN
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

// A 16-byte chunk of T: its raw type, streaming load and widening to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;               // 4 x f32 = 16 bytes
  using Raw = float4;
  __device__ static Raw load(const Raw* p) { return __ldcs(p); }
  __device__ static void widen(const Raw& r, float* out) {
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
  __device__ static float one(const float* p) { return *p; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;               // 8 x bf16 = 16 bytes
  using Raw = uint4;
  __device__ static Raw load(const Raw* p) { return __ldcs(p); }
  __device__ static void widen(const Raw& r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {           // bf16 -> f32 is a 16-bit shift
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// Outputs: the scores (argmax, maxp, margin, negent; o3 unused), or with
// kPartials the accumulators (i1 + vocab_offset, m, s, u, m2).
template <typename T, bool kPartials>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
confidence_kernel(const T* __restrict__ logits, int vocab, int vocab_offset,
                  int32_t* __restrict__ argmax, float* __restrict__ o0,
                  float* __restrict__ o1, float* __restrict__ o2,
                  float* __restrict__ o3) {
  using V = Vec<T>;
  constexpr int N = V::N;
  constexpr int kStep = kLoads * kThreads;  // chunks per CTA step
  const int row = blockIdx.x, t = threadIdx.x;
  const T* x = logits + static_cast<int64_t>(row) * vocab;
  // the row's cut: head up to the first 16-byte boundary, body, tail
  const int mis =
      static_cast<int>(reinterpret_cast<uintptr_t>(x) % 16 / sizeof(T));
  const int head = min((N - mis) % N, vocab);
  const int chunks = (vocab - head) / N;
  const int body_end = head + chunks * N;
  const typename V::Raw* body =
      reinterpret_cast<const typename V::Raw*>(x + head);

  // head and tail logits, loaded first on clamped indices, masked after
  float hv = V::one(x + min(t, vocab - 1));
  float tv = V::one(x + min(body_end + t, vocab - 1));
  hv = t < head ? hv : -INFINITY;
  tv = t < vocab - body_end ? tv : -INFINITY;

  Acc acc;
  init(acc);
  {
    const float h[1] = {hv};
    fold<1, 1, 0>(acc, h, t);
  }
  const int full = chunks / kStep;          // steps with every chunk live
  int c0 = t;
  for (int step = 0; step < full; ++step, c0 += kStep) {
    typename V::Raw r[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      r[k] = V::load(body + c0 + k * kThreads);
    }
    float v[kLoads * N];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) V::widen(r[k], v + k * N);
    fold<kLoads, N, kThreads * N>(acc, v, head + c0 * N);
  }
  if (chunks % kStep) {                     // the last, partial step
    typename V::Raw r[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      r[k] = V::load(body + min(c0 + k * kThreads, chunks - 1));
    }
    float v[kLoads * N];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      V::widen(r[k], v + k * N);
      const bool live = c0 + k * kThreads < chunks;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        v[k * N + e] = live ? v[k * N + e] : -INFINITY;
      }
    }
    fold<kLoads, N, kThreads * N>(acc, v, head + c0 * N);
  }
  {
    const float tl[1] = {tv};
    fold<1, 1, 0>(acc, tl, body_end + t);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(acc, shfl_down(acc, off));

  __shared__ Acc part[kWarps];
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) acc = part[lane]; else init(acc);
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      merge(acc, shfl_down(acc, off));
    }
    if (lane == 0) {
      if constexpr (kPartials) {
        argmax[row] = acc.i1 + vocab_offset;
        o0[row] = acc.m;
        o1[row] = acc.s;
        o2[row] = acc.u;
        o3[row] = acc.m2;
      } else {
        const float inv_s = 1.f / acc.s;
        const float p2 = expf(acc.m2 - acc.m) * inv_s;
        argmax[row] = acc.i1;
        o0[row] = inv_s;                        // max prob
        o1[row] = inv_s - p2;                   // margin
        o2[row] = acc.u * inv_s - (acc.m + logf(acc.s));  // sum p log p
      }
    }
  }
}

template <typename T, bool kPartials>
cudaError_t launch(const void* logits, int rows, int vocab, int vocab_offset,
                   void* argmax, void* o0, void* o1, void* o2, void* o3,
                   cudaStream_t stream) {
  confidence_kernel<T, kPartials><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), vocab, vocab_offset,
      static_cast<int32_t*>(argmax), static_cast<float*>(o0),
      static_cast<float*>(o1), static_cast<float*>(o2),
      static_cast<float*>(o3));
  return cudaGetLastError();
}

template <bool kPartials>
int dispatch(const void* logits, int rows, int vocab, int dtype,
             int vocab_offset, void* argmax, void* o0, void* o1, void* o2,
             void* o3, void* stream) {
  if (rows <= 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, kPartials>(logits, rows, vocab, vocab_offset, argmax,
                                   o0, o1, o2, o3, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, kPartials>(logits, rows, vocab, vocab_offset,
                                           argmax, o0, o1, o2, o3, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int repro_confidence(const void* logits, int rows, int vocab,
                                int dtype, void* argmax, void* maxp,
                                void* margin, void* negent, void* stream) {
  return dispatch<false>(logits, rows, vocab, dtype, 0, argmax, maxp, margin,
                         negent, nullptr, stream);
}

// The partials of a vocab shard whose first id is vocab_offset: per row
// i1 + vocab_offset (int32) and m, s, u, m2 (f32).
extern "C" int repro_confidence_partials(const void* logits, int rows,
                                         int vocab, int dtype,
                                         int vocab_offset, void* i1, void* m,
                                         void* s, void* u, void* m2,
                                         void* stream) {
  return dispatch<true>(logits, rows, vocab, dtype, vocab_offset, i1, m, s, u,
                        m2, stream);
}
