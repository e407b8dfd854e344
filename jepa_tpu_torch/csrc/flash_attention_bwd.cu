// H2: flash self-attention backward over the fused qkv projection, bf16.
//
// Replaces jepa_tpu/ops/flash_attention.py:_dkv_tm_kernel (flash_bwd_dkv_kernel)
// and _dq_tm_kernel (flash_bwd_dq_kernel), the dual-tiled token-major TPU
// backward; together the two compute what the merged _bwd_tm_kernel does.
// This is the deterministic FlashAttention-2 split: no atomics, each
// output element is written by exactly one block.
//
// Inputs: qkv [B, N, 3*H*C] bf16 (read by stride, columns q|k|v, each
// head-major), do [B, N, H*C] bf16 (the gradient of H1's o), lse and
// delta [B, H, N] fp32 (H1's base-2 lse; delta = sum_c do*o). Output:
// dqkv [B, N, 3*H*C] bf16; the dk/dv kernel writes columns [H*C, 3*H*C),
// the dq kernel columns [0, H*C), so no concatenation follows.
//
// Rounding points of the reference kernels: q * (scale*log2e) is rounded
// to bf16 before QK^T; p = exp2(s - lse) is fp32, rounded to bf16 only as
// the operand of dV = p^T do; ds = p * (dp - delta) is rounded to bf16
// before dK = ds^T q and dQ = ds k; dk is scaled by 1/log2e and dq by
// `scale` after the sums. Ragged N: q rows past N get p = ds = 0 in the
// dk/dv kernel, kv columns past N get ds = 0 in the dq kernel, and every
// operand row past N is zero-filled (0 * garbage could be NaN).
//
// What bounds it on the H100: per (batch, head) the backward needs five
// N x N x C products (S, dP, dV, dK, dQ; the split recomputes S and dP in
// both kernels, seven in all) against ~N*C*2*6 bytes of operands, so it
// is compute-bound at the training shapes. Design, the simple first
// kernel: one block of 4 warps owns 64 rows (kv rows in the dk/dv kernel,
// q rows in the dq kernel); each warp keeps its 16 rows' operand
// fragments and fp32 accumulators in registers and loops over the other
// side in 64-row tiles staged in shared memory. Score and gradient tiles
// stay in registers: the mma C-fragments of S^T/dS^T are re-packed as the
// A-fragments of the next product. mma.sync m16n8k16 bf16 with fp32
// accumulation; no cp.async pipelining, ldmatrix, wgmma or TMA yet.
#include "common.cuh"

namespace {

using jt::bf16;

constexpr int BR = 64;      // rows a block owns, 16 per warp
constexpr int BC = 64;      // rows of the other side per inner step
constexpr int THREADS = 128;
constexpr int PAD = 8;      // shared-memory row padding, bf16 elements
constexpr float INV_LOG2E = 0.6931471805599453f;

// rows [r0, r0 + ROWS) of one head's C columns (src points at the head's
// first column of token 0, rows `rs` elements apart) into dst [ROWS][C+PAD];
// rows past N are zero; with `scale` != 1 each value is multiplied in fp32
// and rounded back to bf16.
template <int C, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t rs,
                                          int r0, int N, float scale) {
  constexpr int VEC = C / 8, LD = C + PAD;
  for (int i = threadIdx.x; i < ROWS * VEC; i += THREADS) {
    const int r = i / VEC, cv = i % VEC, n = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n < N) val = *reinterpret_cast<const uint4*>(src + (size_t)n * rs + cv * 8);
    if (scale != 1.f) {
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(&dst[r * LD + cv * 8]) = val;
  }
}

// A-fragments (16 rows from `row`, all C columns) of a row-major tile
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[C / 16][4], const bf16* s,
                                       int row, int t) {
  constexpr int LD = C + PAD;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    a[ks][0] = jt::ld32(&s[row * LD + c0]);
    a[ks][1] = jt::ld32(&s[(row + 8) * LD + c0]);
    a[ks][2] = jt::ld32(&s[row * LD + c0 + 8]);
    a[ks][3] = jt::ld32(&s[(row + 8) * LD + c0 + 8]);
  }
}

// acc[16 x BC] = A (16 x C) . T^T, T a row-major [BC][C] tile in shared memory
template <int C>
__device__ __forceinline__ void mm_abt(float (&acc)[BC / 8][4],
                                       const uint32_t (&a)[C / 16][4],
                                       const bf16* T, int g, int t) {
  constexpr int LD = C + PAD;
#pragma unroll
  for (int nt = 0; nt < BC / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* row = &T[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)
      jt::mma_16816(acc[nt], a[ks], jt::ld32(row + ks * 16), jt::ld32(row + ks * 16 + 8));
  }
}

// acc[16 x C] += A (16 x BC, as re-packed fragments) . T, T a row-major
// [BC][C] tile in shared memory (B-fragments gathered with 16-bit reads)
template <int C>
__device__ __forceinline__ void mm_ab(float (&acc)[C / 8][4],
                                      const uint32_t (&a)[BC / 16][4],
                                      const bf16* T, int g, int t) {
  constexpr int LD = C + PAD;
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const bf16* t0 = &T[(kk * 16 + 2 * t) * LD + g];
#pragma unroll
    for (int ot = 0; ot < C / 8; ++ot) {
      const bf16* v = t0 + ot * 8;
      jt::mma_16816(acc[ot], a[kk], jt::pack2(v[0], v[LD]),
                    jt::pack2(v[8 * LD], v[9 * LD]));
    }
  }
}

// write a warp's 16 x C fp32 accumulator rows (r0, r0 + 8) as bf16 * mul
template <int C>
__device__ __forceinline__ void store_rows(bf16* out, size_t rs, int r0, int N,
                                           const float (&acc)[C / 8][4],
                                           float mul, int t) {
#pragma unroll
  for (int ot = 0; ot < C / 8; ++ot) {
    const int col = ot * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * rs + col) =
          __floats2bfloat162_rn(acc[ot][0] * mul, acc[ot][1] * mul);
    if (r0 + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + 8) * rs + col) =
          __floats2bfloat162_rn(acc[ot][2] * mul, acc[ot][3] * mul);
  }
}

// dk, dv of 64 kv rows of one (batch, head); loops over every q tile
template <int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dqkv, int N, int H, float qscale) {
  constexpr int LD = C + PAD;
  __shared__ __align__(16) bf16 sQ[BC * LD];
  __shared__ __align__(16) bf16 sdO[BC * LD];
  __shared__ float sL[BC], sD[BC];

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;
  const bf16* base = qkv + (size_t)b * N * rs + h * C;
  const bf16* dob = dO + (size_t)b * N * HC + h * C;
  const float* lrow = lse + ((size_t)b * H + h) * N;
  const float* drow = delta + ((size_t)b * H + h) * N;

  // K and V fragments of this warp's 16 kv rows, staged through sQ / sdO
  load_tile<C, BR>(sQ, base + HC, rs, k0, N, 1.f);
  load_tile<C, BR>(sdO, base + 2 * HC, rs, k0, N, 1.f);
  __syncthreads();
  const int kr = warp * 16 + g;
  uint32_t ka[C / 16][4], va[C / 16][4];
  load_a<C>(ka, sQ, kr, t);
  load_a<C>(va, sdO, kr, t);

  float dk[C / 8][4], dv[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += BC) {
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<C, BC>(sQ, base, rs, q0, N, qscale);
    load_tile<C, BC>(sdO, dob, HC, q0, N, 1.f);
    for (int i = tid; i < BC; i += THREADS) {
      const bool ok = q0 + i < N;
      sL[i] = ok ? lrow[q0 + i] : 0.f;
      sD[i] = ok ? drow[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[BC / 8][4], dpt[BC / 8][4];
    mm_abt<C>(st, ka, sQ, g, t);    // S^T  = K Qs^T   (base-2 logits)
    mm_abt<C>(dpt, va, sdO, g, t);  // dP^T = V dO^T

    uint32_t pa[BC / 16][4], dsa[BC / 16][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        const bool ok = q0 + col < N;
        const float L = sL[col], D = sD[col];
        p[j] = ok ? exp2f(st[nt][j] - L) : 0.f;          // kv row g
        p[2 + j] = ok ? exp2f(st[nt][2 + j] - L) : 0.f;  // kv row g + 8
        ds[j] = p[j] * (dpt[nt][j] - D);
        ds[2 + j] = p[2 + j] * (dpt[nt][2 + j] - D);
      }
      const int kk = nt / 2, hi = (nt & 1) * 2;
      pa[kk][hi] = jt::pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
      pa[kk][hi + 1] = jt::pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
      dsa[kk][hi] = jt::pack2(__float2bfloat16(ds[0]), __float2bfloat16(ds[1]));
      dsa[kk][hi + 1] = jt::pack2(__float2bfloat16(ds[2]), __float2bfloat16(ds[3]));
    }
    mm_ab<C>(dv, pa, sdO, g, t);   // dV += P^T dO
    mm_ab<C>(dk, dsa, sQ, g, t);   // dK += dS^T Qs
  }

  bf16* out = dqkv + (size_t)b * N * rs + h * C;
  store_rows<C>(out + HC, rs, k0 + kr, N, dk, INV_LOG2E, t);
  store_rows<C>(out + 2 * HC, rs, k0 + kr, N, dv, 1.f, t);
}

// dq of 64 q rows of one (batch, head); loops over every kv tile
template <int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dqkv, int N, int H, float qscale,
                    float scale) {
  constexpr int LD = C + PAD;
  __shared__ __align__(16) bf16 sK[BC * LD];
  __shared__ __align__(16) bf16 sV[BC * LD];

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;
  const bf16* base = qkv + (size_t)b * N * rs + h * C;
  const bf16* dob = dO + (size_t)b * N * HC + h * C;

  // Qs and dO fragments of this warp's 16 q rows, staged through sK / sV
  load_tile<C, BR>(sK, base, rs, q0, N, qscale);
  load_tile<C, BR>(sV, dob, HC, q0, N, 1.f);
  __syncthreads();
  const int qr = warp * 16 + g;
  uint32_t qa[C / 16][4], da[C / 16][4];
  load_a<C>(qa, sK, qr, t);
  load_a<C>(da, sV, qr, t);
  const int r0 = q0 + qr, r1 = r0 + 8;
  const float* lrow = lse + ((size_t)b * H + h) * N;
  const float* drow = delta + ((size_t)b * H + h) * N;
  const float L0 = r0 < N ? lrow[r0] : 0.f, L1 = r1 < N ? lrow[r1] : 0.f;
  const float D0 = r0 < N ? drow[r0] : 0.f, D1 = r1 < N ? drow[r1] : 0.f;

  float dq[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BC) {
    __syncthreads();
    load_tile<C, BC>(sK, base + HC, rs, k0, N, 1.f);
    load_tile<C, BC>(sV, base + 2 * HC, rs, k0, N, 1.f);
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
    mm_abt<C>(s, qa, sK, g, t);   // S  = Qs K^T
    mm_abt<C>(dp, da, sV, g, t);  // dP = dO V^T

    uint32_t dsa[BC / 16][4];
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + 2 * t + j < N;
        ds[j] = ok ? exp2f(s[nt][j] - L0) * (dp[nt][j] - D0) : 0.f;
        ds[2 + j] = ok ? exp2f(s[nt][2 + j] - L1) * (dp[nt][2 + j] - D1) : 0.f;
      }
      const int kk = nt / 2, hi = (nt & 1) * 2;
      dsa[kk][hi] = jt::pack2(__float2bfloat16(ds[0]), __float2bfloat16(ds[1]));
      dsa[kk][hi + 1] = jt::pack2(__float2bfloat16(ds[2]), __float2bfloat16(ds[3]));
    }
    mm_ab<C>(dq, dsa, sK, g, t);  // dQ += dS K
  }

  store_rows<C>(dqkv + (size_t)b * N * rs + h * C, rs, r0, N, dq, scale, t);
}

template <int C>
int launch_dkv(const void* qkv, const void* dO, const void* lse, const void* delta,
               void* dqkv, int B, int N, int H, float qscale, void* stream) {
  const dim3 grid((N + BR - 1) / BR, H, B);
  flash_bwd_dkv_kernel<C><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)dO, (const float*)lse, (const float*)delta,
      (bf16*)dqkv, N, H, qscale);
  return (int)cudaGetLastError();
}

template <int C>
int launch_dq(const void* qkv, const void* dO, const void* lse, const void* delta,
              void* dqkv, int B, int N, int H, float qscale, float scale,
              void* stream) {
  const dim3 grid((N + BR - 1) / BR, H, B);
  flash_bwd_dq_kernel<C><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)dO, (const float*)lse, (const float*)delta,
      (bf16*)dqkv, N, H, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define JT_BWD_ENTRIES(C)                                                       \
  extern "C" int jt_flash_bwd_dkv_c##C(const void* qkv, const void* dO,         \
                                       const void* lse, const void* delta,      \
                                       void* dqkv, int B, int N, int H,         \
                                       float qscale, void* stream) {            \
    return launch_dkv<C>(qkv, dO, lse, delta, dqkv, B, N, H, qscale, stream);   \
  }                                                                             \
  extern "C" int jt_flash_bwd_dq_c##C(const void* qkv, const void* dO,          \
                                      const void* lse, const void* delta,       \
                                      void* dqkv, int B, int N, int H,          \
                                      float qscale, float scale, void* stream) { \
    return launch_dq<C>(qkv, dO, lse, delta, dqkv, B, N, H, qscale, scale,      \
                        stream);                                                \
  }

JT_BWD_ENTRIES(32)
JT_BWD_ENTRIES(64)
JT_BWD_ENTRIES(80)
