// Bidirectional flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py: non-causal softmax(q k^T d^-1/2) v
// with f32 online-softmax accumulators, an optional band |i - j| < window
// (0 = full) that skips key tiles wholly outside it, and the ragged end of
// Lk masked with the same -1e30 convention.  Beyond the Pallas kernel it
// groups GQA heads natively (kv head = h / (H / G)), so the caller does not
// expand K/V.  Layout is the reference's: q (B, Lq, H, d), k/v (B, Lk, G, d),
// out (B, Lq, H, d); f32 or bf16; d a multiple of 32 up to 256.
//
// Bound: the work is 4*B*H*Lq*Lk*d operations on 4*B*L*H*d*2 bytes (bf16,
// Lq = Lk = L), i.e. L/2 operations per byte.  Below the card's ridge of
// ~295 bf16 operations per byte (L < ~590, the decode shapes) the bytes
// bound it; above, the tensor cores.  This first kernel uses neither well:
// it is plain f32 FMA from shared memory, written to be right first, so
// its arithmetic rather than either bound limits it.  Design: one CTA of 8
// warps per (b*h, 64-query tile); the Q tile and each 64-row K/V tile are
// staged in shared memory as f32 (K rows padded by 4 words so the
// per-lane 16-byte reads hit distinct banks); each warp owns 8 query rows,
// each lane 2 keys of the tile for Q K^T and d/32 output columns for P V;
// P goes through a per-warp shared buffer.  wgmma/mma.sync, TMA and
// double buffering are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kQT = 64;                  // query rows per CTA
constexpr int kKT = 64;                  // key rows per tile (2 per lane)
constexpr int kWarps = 8;
constexpr int kRPW = kQT / kWarps;       // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float elem(float4 a, int i) {
  return i == 0 ? a.x : (i == 1 ? a.y : (i == 2 ? a.z : a.w));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kQT * D + kKT * (D + 4) + kKT * D + kWarps * kRPW * kKT);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
             int H, int G, int window, float scale) {
  constexpr int D = DPL * 32;
  constexpr int KS = D + 4;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kQT * D;
  float* Vs = Ks + kKT * KS;
  float* Ps = Vs + kKT * D;

  const int q0 = blockIdx.x * kQT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < kQT * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = q0 + r;
    Qs[idx] = i < Lq
        ? to_f(q[((static_cast<int64_t>(b) * Lq + i) * H + h) * D + c])
        : 0.f;
  }

  float m[kRPW], lsum[kRPW], acc[kRPW][DPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = kNeg;
    lsum[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }
  float* P = Ps + warp * kRPW * kKT;

  for (int k0 = 0; k0 < Lk; k0 += kKT) {
    if (window > 0) {
      // closest approach of the two tiles decides whether any work exists
      const int dist = max(q0 - (k0 + kKT - 1), k0 - (q0 + kQT - 1));
      if (dist >= window) continue;          // uniform across the CTA
    }
    __syncthreads();                          // previous tile consumed
    for (int idx = tid; idx < kKT * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, j = k0 + r;
      const int64_t off = ((static_cast<int64_t>(b) * Lk + j) * G + g) * D + c;
      Ks[r * KS + c] = j < Lk ? to_f(k[off]) : 0.f;
      Vs[idx] = j < Lk ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kRPW][2];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r][0] = s[r][1] = 0.f;
    const float* q_rows = Qs + warp * kRPW * D;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * KS + c);
      const float4 kb =
          *reinterpret_cast<const float4*>(Ks + (lane + 32) * KS + c);
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_rows + r * D + c);
        s[r][0] += dot4(qv, ka);
        s[r][1] += dot4(qv, kb);
      }
    }

    const int ja = k0 + lane, jb = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int i = q0 + warp * kRPW + r;
      const bool va = ja < Lk && (window == 0 || abs(i - ja) < window);
      const bool vb = jb < Lk && (window == 0 || abs(i - jb) < window);
      const float sa = va ? s[r][0] * scale : kNeg;
      const float sb = vb ? s[r][1] * scale : kNeg;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float alpha = expf(m[r] - m_new);
      const float pa = va ? expf(sa - m_new) : 0.f;
      const float pb = vb ? expf(sb - m_new) : 0.f;
      lsum[r] = lsum[r] * alpha + pa + pb;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= alpha;
      m[r] = m_new;
      P[r * kKT + lane] = pa;
      P[r * kKT + lane + 32] = pb;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kKT; j += 4) {
      float4 pr[kRPW];
#pragma unroll
      for (int r = 0; r < kRPW; ++r)
        pr[r] = *reinterpret_cast<const float4*>(P + r * kKT + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const float vv = Vs[(j + jj) * D + lane + 32 * t];
#pragma unroll
          for (int r = 0; r < kRPW; ++r) acc[r][t] += elem(pr[r], jj) * vv;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const float l = warp_sum(lsum[r]);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int i = q0 + warp * kRPW + r;
    if (i < Lq) {
      T* out = o + ((static_cast<int64_t>(b) * Lq + i) * H + h) * D;
#pragma unroll
      for (int t = 0; t < DPL; ++t) out[lane + 32 * t] = from_f<T>(acc[r][t] * inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Lq, int Lk, int H, int G, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DPL * 32>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Lq + kQT - 1) / kQT, B * H), block(kThreads);
  flash_kernel<T, DPL><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, G, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int B, int Lq, int Lk, int H, int G,
                     int window, float scale, cudaStream_t s) {
  switch (d / 32) {
    case 1: return launch<T, 1>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 5: return launch<T, 5>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 6: return launch<T, 6>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 7: return launch<T, 7>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    case 8: return launch<T, 8>(q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Lq,
                                     int Lk, int H, int G, int d, int window,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      d % 32 != 0 || d < 32 || d > 256 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(d, q, k, v, o, B, Lq, Lk, H, G, window, scale, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(d, q, k, v, o, B, Lq, Lk, H, G, window,
                                  scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
