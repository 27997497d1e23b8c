// Bidirectional flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py: non-causal softmax(q k^T d^-1/2) v
// with f32 online-softmax accumulators, an optional band |i - j| < window
// (0 = full) that skips key tiles wholly outside it, and the ragged end of
// Lk masked.  Query row i sits at position q_offset + i for the band (a
// cached window's rows start at its offset in the canvas; 0 = the rows are
// the whole sequence), key j at j.  A query row with no key inside its band
// gets 0, as in the Pallas kernel.  An optional valid key count read from
// device memory (`kv_len`, an int32*; null = all Lk keys) masks keys at or
// past it as the ragged end is masked: a single-token decode attends over
// the first min(pos + 1, cap) slots of a fixed-capacity cache without the
// host reading the position, so the step stays capturable in a CUDA graph.
// Beyond the Pallas kernel it
// groups GQA heads natively (kv head = h / (H / G)), so the caller does not
// expand K/V.  Layout is the reference's: q (B, Lq, H, dqk), k (B, Lk, G,
// dqk), v (B, Lk, G, dv), out (B, Lq, H, dv); f32 or bf16; the scale is the
// caller's (dqk^-1/2).  Each kernel is instantiated per (dqk, dv) pair of
// FLASH_HEAD_DIM_PAIRS below: dqk = dv at every multiple of 16 in [32, 256],
// and MLA's (192, 128) and (48, 32) (DeepSeek-V2 at full and reduced size:
// q and k carry 128 + 64 "nope" and rope dims, v 128).  S = Q K^T is sized
// by dqk; the P V accumulator, V's shared tile and the output by dv: V is
// never padded to dqk.
//
// Bound: the work is 2*B*H*Lq*Lk*(dqk + dv) operations (fewer under a band)
// on B*(Lq*H*(dqk + dv) + Lk*G*(dqk + dv))*2 bytes (bf16), i.e. at most
// ~L/2 operations per byte at Lq = Lk = L.  Below the card's ridge of ~295
// bf16 operations per byte (L < ~590: the serving shapes, L = 128) the
// bytes bound it; above (the long-context shape, L = 2048 under Hymba's
// 1024 band; DeepSeek-V2's L = 4096) the tensor cores.
//
// bf16, the serving path: FlashAttention-2 on the tensor cores
// (`flash_tc_kernel`).  One CTA of 4 warps owns 64 query rows, 16 per
// warp; its grid is ceil(Lq/64) x B*H CTAs: 128 for LLaDA-8B at B=2,
// L=128 (256 at B=4), 100 for Hymba-1.5B at B=2 (200 at B=4), each one
// wave (registers allow 2 CTAs per SM at d=128, 3 at d=64), and 1600 at
// L=2048.  A 64-row q tile gives each of 4 warps one m16 fragment; a
// 32-row tile of 2 warps would double the CTAs but not the warps in
// flight, and would load every K/V tile twice as often.  Per 64-key tile:
//   - K and V stay bf16 in shared memory, rows padded by 16 bytes so the
//     eight 16-byte rows an `ldmatrix` phase reads fall in distinct banks;
//     they are double-buffered, the next tile's 16-byte `cp.async.cg`
//     copies in flight while the tensor cores work on this one;
//   - S = Q K^T on `mma.sync.m16n8k16` (bf16 in, f32 out), Q's fragments
//     loaded once with `ldmatrix` and held in registers for d <= 128 (for
//     d > 128 they are re-read from shared memory per k-step, which keeps
//     the accumulator of d/8 x 4 floats per lane out of local memory);
//   - the row max and row sum reduce across the quad of lanes that holds a
//     row; exp2 with the scale folded into log2(e);
//   - P is rounded to bf16 in registers, where the S accumulator's layout
//     is already the A operand's, and fed to P V with V read through
//     `ldmatrix.trans`: P never touches shared memory.
// The epilogue divides by l, rounds to bf16 and skips ragged query rows.
// The band's whole-tile skip is the Pallas kernel's closest-approach test,
// turned into the interval of live key tiles; tiles that straddle the band
// edge or the ragged end of Lk are masked per element, the rest not.  GQA
// heads are not packed into one CTA (each query head re-reads its group's
// K/V tiles, from L2): at the serving shapes the K/V bytes are a few MB
// and the grid is already under a wave.  Not yet used: wgmma, TMA and
// warp specialisation.  The q offset moves only the band arithmetic (the
// live-tile interval, the edge test and the element mask); Q's tile loads
// and the output stores keep local row indices.
//
// A head dim that is a multiple of 16 fits both designs: m16n8k16 takes
// dqk/16 k-steps of Q K^T and dv/8 (even) 8-column tiles of P V, a row is
// d/8 (even) 16-byte chunks, 64 rows of them an exact number of 128-thread
// rounds, and the shared pitch d + 8 is an odd count of 16-byte units, so
// an ldmatrix phase stays conflict-free (d = 80: 5 k-steps, 10 n-tiles,
// 10 chunks a row, pitch 88).  Q and K share the pitch dqk + 8, V has its
// own, dv + 8 (MLA: 200 and 136; Q re-read from shared memory per k-step,
// as at any dqk > 128).
//
// f32, the reference phase's path: the first kernel, plain f32 FMA from
// shared memory (`flash_kernel<float, DQ, DV>`), unchanged for dv a
// multiple of 32; other multiples of 16 mask the lanes of the last column
// round.  The card's f32 decodes of the reduced configs must equal the
// CPU's token for token; random weights put every max-probability near
// 1/V, so scores moved by TF32's or bf16's ~1e-3 (the tensor cores' f32
// inputs) flip argmaxes.  Design: one CTA of 8 warps per (b*h, 64-query
// tile); the Q tile and each 64-row K/V tile are staged in shared memory
// as f32 (K rows padded by 4 words so the per-lane 16-byte reads hit
// distinct banks);
// each warp owns 8 query rows, each lane 2 keys of the tile for Q K^T and
// the output columns lane + 32 t, t < ceil(dv/32), for P V (at dv = 80
// lanes 16..31 idle in the third round: their columns are never stored); P
// goes through a per-warp shared buffer.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <atomic>
#include <cmath>

// (dqk, dv) pairs each kernel is instantiated for: dqk = dv at every
// multiple of 16 in [32, 256], then MLA's two.  X(DQ, DV) expands once per
// pair (the dispatch's switch cases).
#define FLASH_HEAD_DIM_PAIRS(X)                                             \
  X(32, 32) X(48, 48) X(64, 64) X(80, 80) X(96, 96) X(112, 112)             \
  X(128, 128) X(144, 144) X(160, 160) X(176, 176) X(192, 192) X(208, 208)   \
  X(224, 224) X(240, 240) X(256, 256) X(192, 128) X(48, 32)

namespace {

// A kernel's dynamic shared-memory limit is a per-device attribute: it is
// set at a kernel's first launch on each device (`done` holds one bit per
// device, one `done` per kernel), not on every launch, so a launch
// recorded into a CUDA graph is a kernel node alone.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes,
                          std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

constexpr int kQT = 64;                  // query rows per CTA
constexpr int kKT = 64;                  // key rows per tile (2 per lane)
constexpr int kWarps = 8;
constexpr int kRPW = kQT / kWarps;       // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// The count of live keys, [0, Lk] (kv_len null: all Lk).  Both kernels
// stage it in shared memory and read it there at each use instead of
// holding it in a register through the tile loop: one more live register
// spills the bf16 kernel at d = 80 and the f32 kernel at 160 <= d <= 192.
__device__ __forceinline__ int live_keys(const int* kv_len, int Lk) {
  return kv_len ? max(0, min(*kv_len, Lk)) : Lk;
}
__device__ __forceinline__ int staged(const int& s_keys) {
  return *static_cast<const volatile int*>(&s_keys);
}

template <int DQ, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kQT * DQ + kKT * (DQ + 4) + kKT * DV + kWarps * kRPW * kKT);
}

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
             int H, int G, int window, int q_offset, float scale,
             const int* __restrict__ kv_len) {
  constexpr int DPL = (DV + 31) / 32;     // column rounds of P V per lane
  constexpr int KS = DQ + 4;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kQT * DQ;
  float* Vs = Ks + kKT * KS;
  float* Ps = Vs + kKT * DV;

  const int q0 = blockIdx.x * kQT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // keys [0, s_keys) are live; Lk stays the row stride of k and v
  __shared__ int s_keys;
  if (tid == 0) s_keys = live_keys(kv_len, Lk);

  for (int idx = tid; idx < kQT * DQ; idx += kThreads) {
    const int r = idx / DQ, c = idx % DQ, i = q0 + r;
    Qs[idx] = i < Lq
        ? to_f(q[((static_cast<int64_t>(b) * Lq + i) * H + h) * DQ + c])
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

  __syncthreads();                            // s_keys written
  for (int k0 = 0; k0 < staged(s_keys); k0 += kKT) {
    if (window > 0) {
      // closest approach of the two tiles decides whether any work exists
      const int p0 = q_offset + q0;           // position of the tile's row 0
      const int dist = max(p0 - (k0 + kKT - 1), k0 - (p0 + kQT - 1));
      if (dist >= window) continue;          // uniform across the CTA
    }
    __syncthreads();                          // previous tile consumed
    const int n_keys = staged(s_keys);
    // at dqk = dv one loop loads K and V side by side: two loops cost the
    // equal-dim kernel ~12% of its device time on an H100
    for (int idx = tid; idx < kKT * DQ; idx += kThreads) {
      const int r = idx / DQ, c = idx % DQ, j = k0 + r;
      const int64_t row = (static_cast<int64_t>(b) * Lk + j) * G + g;
      Ks[r * KS + c] = j < n_keys ? to_f(k[row * DQ + c]) : 0.f;
      if constexpr (DQ == DV)
        Vs[idx] = j < n_keys ? to_f(v[row * DV + c]) : 0.f;
    }
    if constexpr (DQ != DV) {
      for (int idx = tid; idx < kKT * DV; idx += kThreads) {
        const int r = idx / DV, c = idx % DV, j = k0 + r;
        const int64_t row = (static_cast<int64_t>(b) * Lk + j) * G + g;
        Vs[idx] = j < n_keys ? to_f(v[row * DV + c]) : 0.f;
      }
    }
    __syncthreads();

    float s[kRPW][2];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r][0] = s[r][1] = 0.f;
    const float* q_rows = Qs + warp * kRPW * DQ;
#pragma unroll 4
    for (int c = 0; c < DQ; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * KS + c);
      const float4 kb =
          *reinterpret_cast<const float4*>(Ks + (lane + 32) * KS + c);
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_rows + r * DQ + c);
        s[r][0] += dot4(qv, ka);
        s[r][1] += dot4(qv, kb);
      }
    }

    const int ja = k0 + lane, jb = k0 + lane + 32;
    const int n_live = staged(s_keys);
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int i = q_offset + q0 + warp * kRPW + r;   // position
      const bool va = ja < n_live && (window == 0 || abs(i - ja) < window);
      const bool vb = jb < n_live && (window == 0 || abs(i - jb) < window);
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
          // past dv (dv % 32 = 16, last round) a lane reads column 0 and
          // its sums are never stored
          const int col =
              DV % 32 == 0 || lane + 32 * t < DV ? lane + 32 * t : 0;
          const float vv = Vs[(j + jj) * DV + col];
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
      T* out = o + ((static_cast<int64_t>(b) * Lq + i) * H + h) * DV;
#pragma unroll
      for (int t = 0; t < DPL; ++t)
        if (DV % 32 == 0 || lane + 32 * t < DV)
          out[lane + 32 * t] = from_f<T>(acc[r][t] * inv);
    }
  }
}

template <typename T, int DQ, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Lq, int Lk, int H, int G, int window,
                   int q_offset, float scale, const int* kv_len,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DQ, DV>();
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t err =
      set_smem_once(flash_kernel<T, DQ, DV>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kQT - 1) / kQT, B * H), block(kThreads);
  flash_kernel<T, DQ, DV><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, G, window,
      q_offset, scale, kv_len);
  return cudaGetLastError();
}

// the dispatch's switch key of a (dqk, dv) pair
constexpr int pair_key(int dqk, int dv) { return dqk * 1024 + dv; }

template <typename T>
cudaError_t dispatch(int dqk, int dv, const void* q, const void* k,
                     const void* v, void* o, int B, int Lq, int Lk, int H,
                     int G, int window, int q_offset, float scale,
                     const int* kv_len, cudaStream_t s) {
  auto go = [&](auto launcher) {
    return launcher(q, k, v, o, B, Lq, Lk, H, G, window, q_offset, scale,
                    kv_len, s);
  };
  switch (pair_key(dqk, dv)) {
#define FLASH_CASE(DQ, DV) \
    case pair_key(DQ, DV): return go(launch<T, DQ, DV>);
    FLASH_HEAD_DIM_PAIRS(FLASH_CASE)
#undef FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.  Fragment layouts of mma.m16n8k16 (PTX ISA), with
// lane = 4 * grp + qd: the A tile (16 x 16, row-major) is four 32-bit
// registers holding rows {grp, grp + 8} x columns {2qd, 2qd + 1} and the
// same plus 8 columns; B (16 x 8, k-major) is two registers, k rows
// {2qd, 2qd + 1} and {2qd + 8, 2qd + 9} at column grp; the f32 C tile is
// c0, c1 at row grp, columns 2qd, 2qd + 1 and c2, c3 at row grp + 8.  One
// `ldmatrix.x4` loads four 8 x 8 blocks, lanes 8m..8m+7 giving the row
// addresses of block m, and returns block m in register m in exactly the
// A/B layout (`.trans` transposes each block on the way).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;              // query rows per CTA, 16 per warp
constexpr int kKeys = 64;              // keys per K/V tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

template <int DQ, int DV>
constexpr size_t smem_bytes() {         // Q, then 2 K and 2 V buffers
  return sizeof(bf16) * (static_cast<size_t>(kRows + 2 * kKeys) * (DQ + kPad)
                         + static_cast<size_t>(2 * kKeys) * (DV + kPad));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b on the tensor cores: bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half (the
// lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Rows [r0, r0 + 64) of a bf16 matrix with row stride `stride` (elements)
// into a shared tile of pitch D + kPad; rows at or past n_rows are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int r0, int n_rows,
                                          int tid) {
  constexpr int kChunks = D / 8;         // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * kChunks / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r0 + r < n_rows;
    const bf16* from = src + (ok ? r0 + r : 0) * stride + c * 8;
    cp_async_16(smem_addr(dst + r * (D + kPad) + c * 8), from, ok ? 16 : 0);
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Lq,
                int Lk, int H, int G, int window, int q_offset,
                float scale_log2, const int* kv_len) {
  constexpr int P = DQ + kPad;           // Q's and K's shared pitch, elements
  constexpr int PV = DV + kPad;          // V's
  constexpr int KD = DQ / 16;            // k-steps of Q K^T
  constexpr int ND = DV / 8;             // 8-column tiles of O
  constexpr int NS = kKeys / 8;          // 8-column tiles of S
  constexpr bool kQInRegs = DQ <= 128;
  extern __shared__ uint4 tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + kRows * P;
  bf16* Vs = Ks + 2 * kKeys * P;

  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q_stride = static_cast<int64_t>(H) * DQ;
  const int64_t k_stride = static_cast<int64_t>(G) * DQ;
  const int64_t v_stride = static_cast<int64_t>(G) * DV;
  const bf16* qb = q + (static_cast<int64_t>(b) * Lq * H + h) * DQ;
  const bf16* kb = k + (static_cast<int64_t>(b) * Lk * G + g) * DQ;
  const bf16* vb = v + (static_cast<int64_t>(b) * Lk * G + g) * DV;

  // Live key tiles [lo, hi): a tile works iff the closest approach of the
  // two tiles is inside the band (an interval, since the distance is
  // V-shaped in the tile index); uniform across the CTA.  The band sees
  // the tile's rows at positions p0 .. p0 + 63.
  const int p0 = q_offset + q0;
  // keys [0, s_keys) are live; Lk stays the row stride of k and v
  __shared__ int s_keys;
  if (tid == 0) s_keys = live_keys(kv_len, Lk);
  __syncthreads();
  int lo = 0, hi = (staged(s_keys) + kKeys - 1) / kKeys;
  if (window > 0) {
    auto dist = [&](int t) {
      const int k0 = t * kKeys;
      return max(p0 - (k0 + kKeys - 1), k0 - (p0 + kRows - 1));
    };
    while (lo < hi && dist(lo) >= window) ++lo;
    while (hi > lo && dist(hi - 1) >= window) --hi;
  }

  load_tile<DQ>(Qs, qb, q_stride, q0, Lq, tid);
  if (lo < hi) {
    const int n_keys = staged(s_keys);
    load_tile<DQ>(Ks, kb, k_stride, lo * kKeys, n_keys, tid);
    load_tile<DV>(Vs, vb, v_stride, lo * kKeys, n_keys, tid);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane: Q as A (rows lane % 16, column
  // block lane / 16); K as B (keys 8 (lane / 16) + lane % 8, column block
  // (lane / 8) % 2); V as B through .trans (keys 8 ((lane / 8) % 2) +
  // lane % 8, column block lane / 16).
  const uint32_t q_addr =
      smem_addr(Qs + (warp * 16 + lane % 16) * P + (lane / 16) * 8);
  const int k_off = ((lane / 16) * 8 + lane % 8) * P + ((lane / 8) % 2) * 8;
  const int v_off = (((lane / 8) % 2) * 8 + lane % 8) * PV + (lane / 16) * 8;
  const int i0 = q0 + warp * 16 + lane / 4;     // this lane's rows i0, i0+8

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};        // row max of raw scores
  float l[2] = {0.f, 0.f};                    // this lane's share of l
  uint32_t qf[kQInRegs ? KD : 1][4];

  for (int t = lo; t < hi; ++t) {
    const int buf = (t - lo) & 1;
    if (t + 1 < hi) {                         // next tile into the other buffer
      const int n_keys = staged(s_keys);
      load_tile<DQ>(Ks + (buf ^ 1) * kKeys * P, kb, k_stride,
                    (t + 1) * kKeys, n_keys, tid);
      load_tile<DV>(Vs + (buf ^ 1) * kKeys * PV, vb, v_stride,
                    (t + 1) * kKeys, n_keys, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (t == lo) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldsm_x4(q_addr + kk * 32, qf[kk]);
      }
    }

    // S = Q K^T, 16 rows x 64 keys per warp
    const uint32_t k_tile = smem_addr(Ks + buf * kKeys * P + k_off);
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if constexpr (kQInRegs) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1];
        qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_x4(q_addr + kk * 32, qa);
      }
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        ldsm_x4(k_tile + (n * 8 * P + kk * 16) * 2, kf);
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
      }
    }

    // per-element mask only on tiles that straddle the band's edge or the
    // ragged end of the live keys
    const int k0 = t * kKeys;
    const int n_keys = staged(s_keys);
    const bool ragged = k0 + kKeys > n_keys;
    const bool edge = window > 0 &&
        max(p0 + kRows - 1 - k0, k0 + kKeys - 1 - p0) >= window;
    if (ragged || edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const int i = q_offset + i0 + (e >> 1) * 8;   // position
          if (j >= n_keys || (window > 0 && abs(i - j) >= window))
            s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax; a lane holds 2 rows, a row lives in one quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no live key yet keeps base 0, so exp2(-inf) = 0
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      const float alpha = exp2f(m[r] * scale_log2 - base[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    // P in bf16, straight from S's layout into the A operand of P V
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = exp2f(fmaf(s[n][0], scale_log2, -base[0]));
      const float p1 = exp2f(fmaf(s[n][1], scale_log2, -base[0]));
      const float p2 = exp2f(fmaf(s[n][2], scale_log2, -base[1]));
      const float p3 = exp2f(fmaf(s[n][3], scale_log2, -base[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
    const uint32_t v_tile = smem_addr(Vs + buf * kKeys * PV + v_off);
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(v_tile + (kc * 16 * PV + n * 8) * 2, vf);
        mma_bf16(acc[n], pa[kc], vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa[kc], vf[2], vf[3]);
      }
    }
    __syncthreads();                          // buffer free for tile t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int i = i0 + r * 8;
    if (i < Lq) {
      bf16* out = o + ((static_cast<int64_t>(b) * Lq + i) * H + h) * DV +
                  (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int DQ, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Lq, int Lk, int H, int G, int window,
                   int q_offset, float scale, const int* kv_len,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DQ, DV>();
  static std::atomic<unsigned> smem_set{0};
  const cudaError_t err =
      set_smem_once(flash_tc_kernel<DQ, DV>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kRows - 1) / kRows, B * H), block(kThreads);
  flash_tc_kernel<DQ, DV><<<grid, block, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Lq, Lk, H, G,
      window, q_offset, scale * kLog2e, kv_len);
  return cudaGetLastError();
}

cudaError_t dispatch(int dqk, int dv, const void* q, const void* k,
                     const void* v, void* o, int B, int Lq, int Lk, int H,
                     int G, int window, int q_offset, float scale,
                     const int* kv_len, cudaStream_t s) {
  // cp.async moves 16-byte chunks: every base address must be aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  auto go = [&](auto launcher) {
    return launcher(q, k, v, o, B, Lq, Lk, H, G, window, q_offset, scale,
                    kv_len, s);
  };
  switch (pair_key(dqk, dv)) {
#define FLASH_CASE(DQ, DV) \
    case pair_key(DQ, DV): return go(launch<DQ, DV>);
    FLASH_HEAD_DIM_PAIRS(FLASH_CASE)
#undef FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core
// kernel; q, k, v and o 16-byte aligned).  dqk is q's and k's head dim, dv
// v's and the output's; a pair outside FLASH_HEAD_DIM_PAIRS is refused.
// q_offset >= 0 is the position of query row 0 for the band.  kv_len, a
// device pointer to one int32 or null, is the count of live keys (clamped
// to [0, Lk]; null = Lk): the kernel reads it, the host never does.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Lq,
                                     int Lk, int H, int G, int dqk, int dv,
                                     int window, int q_offset, float scale,
                                     int dtype, const int* kv_len,
                                     void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      window < 0 || q_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(dqk, dv, q, k, v, o, B, Lq, Lk, H, G, window,
                          q_offset, scale, kv_len, s);
  } else if (dtype == 1) {
    err = tc::dispatch(dqk, dv, q, k, v, o, B, Lq, Lk, H, G, window,
                       q_offset, scale, kv_len, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
