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
// Key mask (the masked instances of _dkv_tm_kernel and _dq_tm_kernel, their
// mask_ref branches): an optional kvm [B, N] uint8 (1 = valid key). A
// masked score is set to -1e30 before p = exp2(s - lse), so p = ds = 0 on
// every masked key and its dk and dv come out exactly 0. The dk/dv kernel
// reads the bytes of the two kv rows each thread owns, the dq kernel the
// bytes of each 64-key tile, so pads anywhere in the row are handled. The
// mask is a template flag: the unmasked instances are the code as before.
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
//
// Head dim 128 (vit_tiny's 384-wide predictor): the dk/dv accumulators
// alone take 128 registers a thread, so at C=128 a step covers 32 rows of
// the other side (not 64) and the dk/dv kernel reads its K and V
// fragments from shared memory instead of keeping them in registers. The
// tiles live in dynamic shared memory (52 KB at C=128).
#include "common.cuh"

namespace {

using jt::bf16;
using jt::kPad;

constexpr int BR = 64;      // rows a block owns, 16 per warp
constexpr float INV_LOG2E = 0.6931471805599453f;

// rows of the other side per inner step
template <int C>
constexpr int kNB = C > 80 ? 32 : 64;
// the dk/dv kernel keeps its K and V fragments in shared memory, not registers
template <int C>
constexpr bool kKvSmem = C > 80;

template <int C>
constexpr int dkv_smem() {
  constexpr int NB = kNB<C>, LD = C + kPad;
  constexpr int QROWS = kKvSmem<C> ? NB : BR;  // K/V are staged through sQ/sdO otherwise
  return (2 * QROWS + (kKvSmem<C> ? 2 * BR : 0)) * LD * 2 + 2 * NB * 4;
}

template <int C>
constexpr int dq_smem() { return 2 * BR * (C + kPad) * 2 + kNB<C>; }

// dk, dv of 64 kv rows of one (batch, head); loops over every q tile
template <int C, bool MASKED>
__global__ void __launch_bounds__(jt::kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ kvm,
                     const bf16* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dqkv, int N, int H, float qscale) {
  constexpr int NB = kNB<C>, LD = C + kPad;
  constexpr bool KV_SMEM = kKvSmem<C>;
  constexpr int QROWS = KV_SMEM ? NB : BR;
  bf16* sQ = jt::smem_bf16();
  bf16* sdO = sQ + QROWS * LD;
  bf16* sK = sdO + QROWS * LD;  // KV_SMEM only
  bf16* sV = sK + BR * LD;
  float* sL = reinterpret_cast<float*>(KV_SMEM ? sV + BR * LD : sK);
  float* sD = sL + NB;

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;
  const bf16* base = qkv + (size_t)b * N * rs + h * C;
  const bf16* dob = dO + (size_t)b * N * HC + h * C;
  const float* lrow = lse + ((size_t)b * H + h) * N;
  const float* drow = delta + ((size_t)b * H + h) * N;
  const int kr = warp * 16 + g;

  // K and V of this block's 64 kv rows: tiles read at every step (KV_SMEM),
  // or fragments of this warp's 16 rows in registers, staged through sQ / sdO
  [[maybe_unused]] uint32_t ka[C / 16][4], va[C / 16][4];
  if constexpr (KV_SMEM) {
    jt::load_tile<C, BR>(sK, base + HC, rs, k0, N, 1.f);
    jt::load_tile<C, BR>(sV, base + 2 * HC, rs, k0, N, 1.f);
  } else {
    jt::load_tile<C, BR>(sQ, base + HC, rs, k0, N, 1.f);
    jt::load_tile<C, BR>(sdO, base + 2 * HC, rs, k0, N, 1.f);
    __syncthreads();
    jt::load_a<C>(ka, sQ, kr, t);
    jt::load_a<C>(va, sdO, kr, t);
  }
  // this thread's kv rows k0 + kr and k0 + kr + 8: masked (or past N) ones
  // get s = -1e30
  [[maybe_unused]] bool valid0 = true, valid1 = true;
  if constexpr (MASKED) {
    const uint8_t* mrow = kvm + (size_t)b * N;
    valid0 = k0 + kr < N && mrow[k0 + kr];
    valid1 = k0 + kr + 8 < N && mrow[k0 + kr + 8];
  }

  float dk[C / 8][4], dv[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += NB) {
    __syncthreads();  // every warp is done with the previous tiles
    jt::load_tile<C, NB>(sQ, base, rs, q0, N, qscale);
    jt::load_tile<C, NB>(sdO, dob, HC, q0, N, 1.f);
    for (int i = tid; i < NB; i += jt::kThreads) {
      const bool ok = q0 + i < N;
      sL[i] = ok ? lrow[q0 + i] : 0.f;
      sD[i] = ok ? drow[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[NB / 8][4], dpt[NB / 8][4];
    if constexpr (KV_SMEM) {
      jt::mm_abt_s<C, NB>(st, sK, kr, sQ, g, t);    // S^T  = K Qs^T (base-2 logits)
      jt::mm_abt_s<C, NB>(dpt, sV, kr, sdO, g, t);  // dP^T = V dO^T
    } else {
      jt::mm_abt<C, NB>(st, ka, sQ, g, t);
      jt::mm_abt<C, NB>(dpt, va, sdO, g, t);
    }

    uint32_t pa[NB / 16][4], dsa[NB / 16][4];
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        const bool ok = q0 + col < N;
        const float L = sL[col], D = sD[col];
        if constexpr (MASKED) {
          if (!valid0) st[nt][j] = -1e30f;
          if (!valid1) st[nt][2 + j] = -1e30f;
        }
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
    jt::mm_ab<C, NB>(dv, pa, sdO, g, t);   // dV += P^T dO
    jt::mm_ab<C, NB>(dk, dsa, sQ, g, t);   // dK += dS^T Qs
  }

  bf16* out = dqkv + (size_t)b * N * rs + h * C;
  jt::store_rows<C>(out + HC, rs, k0 + kr, N, dk, INV_LOG2E, t);
  jt::store_rows<C>(out + 2 * HC, rs, k0 + kr, N, dv, 1.f, t);
}

// dq of 64 q rows of one (batch, head); loops over every kv tile
template <int C, bool MASKED>
__global__ void __launch_bounds__(jt::kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ kvm,
                    const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dqkv, int N, int H, float qscale,
                    float scale) {
  constexpr int NB = kNB<C>, LD = C + kPad;
  bf16* sK = jt::smem_bf16();  // BR rows: they stage Q and dO first
  bf16* sV = sK + BR * LD;
  uint8_t* sM = reinterpret_cast<uint8_t*>(sV + BR * LD);  // the kv tile's mask (MASKED)

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;
  const bf16* base = qkv + (size_t)b * N * rs + h * C;
  const bf16* dob = dO + (size_t)b * N * HC + h * C;

  // Qs and dO fragments of this warp's 16 q rows, staged through sK / sV
  jt::load_tile<C, BR>(sK, base, rs, q0, N, qscale);
  jt::load_tile<C, BR>(sV, dob, HC, q0, N, 1.f);
  __syncthreads();
  const int qr = warp * 16 + g;
  uint32_t qa[C / 16][4], da[C / 16][4];
  jt::load_a<C>(qa, sK, qr, t);
  jt::load_a<C>(da, sV, qr, t);
  const int r0 = q0 + qr, r1 = r0 + 8;
  const float* lrow = lse + ((size_t)b * H + h) * N;
  const float* drow = delta + ((size_t)b * H + h) * N;
  const float L0 = r0 < N ? lrow[r0] : 0.f, L1 = r1 < N ? lrow[r1] : 0.f;
  const float D0 = r0 < N ? drow[r0] : 0.f, D1 = r1 < N ? drow[r1] : 0.f;

  float dq[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += NB) {
    __syncthreads();
    jt::load_tile<C, NB>(sK, base + HC, rs, k0, N, 1.f);
    jt::load_tile<C, NB>(sV, base + 2 * HC, rs, k0, N, 1.f);
    if constexpr (MASKED) {
      if (tid < NB) sM[tid] = k0 + tid < N ? kvm[(size_t)b * N + k0 + tid] : 0;
    }
    __syncthreads();

    float s[NB / 8][4], dp[NB / 8][4];
    jt::mm_abt<C, NB>(s, qa, sK, g, t);   // S  = Qs K^T
    jt::mm_abt<C, NB>(dp, da, sV, g, t);  // dP = dO V^T

    uint32_t dsa[NB / 16][4];
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + 2 * t + j < N;
        if constexpr (MASKED) {
          if (!sM[nt * 8 + 2 * t + j]) s[nt][j] = s[nt][2 + j] = -1e30f;
        }
        ds[j] = ok ? exp2f(s[nt][j] - L0) * (dp[nt][j] - D0) : 0.f;
        ds[2 + j] = ok ? exp2f(s[nt][2 + j] - L1) * (dp[nt][2 + j] - D1) : 0.f;
      }
      const int kk = nt / 2, hi = (nt & 1) * 2;
      dsa[kk][hi] = jt::pack2(__float2bfloat16(ds[0]), __float2bfloat16(ds[1]));
      dsa[kk][hi + 1] = jt::pack2(__float2bfloat16(ds[2]), __float2bfloat16(ds[3]));
    }
    jt::mm_ab<C, NB>(dq, dsa, sK, g, t);  // dQ += dS K
  }

  jt::store_rows<C>(dqkv + (size_t)b * N * rs + h * C, rs, r0, N, dq, scale, t);
}

// kvm == nullptr launches the unmasked instances
template <int C>
int launch_dkv(const void* qkv, const void* kvm, const void* dO, const void* lse,
               const void* delta, void* dqkv, int B, int N, int H, float qscale,
               void* stream) {
  const dim3 grid((N + BR - 1) / BR, H, B);
  return jt::launch(kvm ? flash_bwd_dkv_kernel<C, true> : flash_bwd_dkv_kernel<C, false>,
                    grid, jt::kThreads, dkv_smem<C>(), stream, (const bf16*)qkv, (const uint8_t*)kvm,
                    (const bf16*)dO, (const float*)lse, (const float*)delta, (bf16*)dqkv,
                    N, H, qscale);
}

template <int C>
int launch_dq(const void* qkv, const void* kvm, const void* dO, const void* lse,
              const void* delta, void* dqkv, int B, int N, int H, float qscale,
              float scale, void* stream) {
  const dim3 grid((N + BR - 1) / BR, H, B);
  return jt::launch(kvm ? flash_bwd_dq_kernel<C, true> : flash_bwd_dq_kernel<C, false>,
                    grid, jt::kThreads, dq_smem<C>(), stream, (const bf16*)qkv, (const uint8_t*)kvm,
                    (const bf16*)dO, (const float*)lse, (const float*)delta, (bf16*)dqkv,
                    N, H, qscale, scale);
}

}  // namespace

#define JT_BWD_ENTRIES(C)                                                       \
  extern "C" int jt_flash_bwd_dkv_c##C(const void* qkv, const void* kvm,        \
                                       const void* dO, const void* lse,         \
                                       const void* delta, void* dqkv, int B,    \
                                       int N, int H, float qscale,              \
                                       void* stream) {                          \
    return launch_dkv<C>(qkv, kvm, dO, lse, delta, dqkv, B, N, H, qscale,       \
                         stream);                                               \
  }                                                                             \
  extern "C" int jt_flash_bwd_dq_c##C(const void* qkv, const void* kvm,         \
                                      const void* dO, const void* lse,          \
                                      const void* delta, void* dqkv, int B,     \
                                      int N, int H, float qscale, float scale,  \
                                      void* stream) {                           \
    return launch_dq<C>(qkv, kvm, dO, lse, delta, dqkv, B, N, H, qscale, scale, \
                        stream);                                                \
  }

JT_BWD_ENTRIES(32)
JT_BWD_ENTRIES(64)
JT_BWD_ENTRIES(80)
JT_BWD_ENTRIES(128)
