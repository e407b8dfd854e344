// H4-H7: head-major flash attention, forward and backward, bf16.
//
// Replaces the head-major TPU kernels of jepa_tpu/ops/flash_attention.py:
//   H4 flash_hm_fwd_kernel                 <- _fwd_kernel   (K6, :122)
//   H5 flash_hm_dq_kernel                  <- _dq_kernel    (K7, :225)
//   H6 flash_hm_dkv_kernel<.., false>      <- _dkv_kernel   (K8, :254)
//   H7 flash_hm_dkv_kernel<.., true> and
//      flash_hm_dq_finish_kernel           <- _dqkv_kernel  (K9, :318)
// They serve flash_attention_bhnd / flash_attention_packed /
// flash_attention (ops/flash_attention.py), which the port reaches from
// dot_product_attention(impl='flash') and from flash_self_attention where
// no token-major head split exists (vit_tiny's 3 heads of 64).
//
// Operands: q [B, H, Nq, C], k, v [B, H, Nk, C] and the other [B, H, N, C]
// tensors are read and written by (batch, head, row) strides with a
// contiguous head dim (HmArgs), so the three planes of a packed
// [3, B, H, N, C] qkv, or a permuted view of the token-major projection
// [B, N, 3*H*C], are used in place. lse and delta are [B, H, Nq] fp32; the
// optional key mask kvm is [B, Nk] uint8 (1 = valid), a template flag: the
// JAX package's row mask [B, 8, Nk] (K6, K7) and column mask [B, Nk, 8]
// (K8, K9) are both this one array. C in {32, 64}.
//
// Numerics of K6: q * (scale*log2e) rounded to bf16 before QK^T; a
// masked score is -1e30 before the row max; p = exp2(s - m) in fp32; the
// denominator l is the fp32 sum of the *unrounded* p (H1 sums the rounded
// p, as K1 does); p is rounded to bf16 only as the PV operand; o = acc /
// max(l, 1e-30), lse = m + log2(max(l, 1e-30)). A row with no valid key
// gets the uniform average (p = 1 against its max of -1e30), as K6 gives.
// The softmax is the online form (FlashAttention-2): p rounds against the
// running max, which K6's one-shot row max reaches after the first tile
// that holds it. Backward (K7-K9): p = exp2(s - lse) fp32, rounded to bf16
// only as the dV operand; ds = p * (dp - delta) rounded to bf16 before dK,
// dQ; dk scaled by 1/log2e, dq by `scale`; delta = sum_c do*o in fp32
// plain torch. Ragged Nq and Nk: rows past the end are zero-filled in
// every tile and get p = ds = 0.
//
// What bounds it on the H100: as H1/H2 (csrc/flash_attention{,_bwd}.cu),
// 4*Nq*Nk*C forward and 10*Nq*Nk*C (merged) backward flops per head against
// O((Nq + Nk)*C) bytes, compute-bound at vit_tiny's N = 1568 on the
// tensor cores and the exp2 unit. Design, the simple first kernels: a
// block of 4 warps owns 64 rows (q rows in H4 and H5, kv rows in H6 and
// H7), each warp 16 of them with fp32 accumulators in registers, and loops
// over the other side in 64-row tiles staged in shared memory; mma.sync
// m16n8k16 bf16 with fp32 accumulation; score and gradient tiles stay in
// registers, their C-fragments re-packed as the next product's A-fragments.
//
// H7, the merged backward: per k-block dK/dV as in H6 plus dQ's partial
// over the block's 64 keys, dS (written to shared memory, transposed) times
// K. Several k-blocks write every dq row, and Hopper's blocks run in no
// order (K9 sums them in VMEM scratch because the TPU grid runs in order),
// so each k-block stores its fp32 partial in its own slab of a workspace
// [ceil(Nk/64), B, H, Nq, C], and a second kernel sums the slabs in k-block
// order, scales and casts into dq: deterministic, at the cost of
// ceil(Nk/64) times dq's size in fp32 scratch. K rows past Nk are zero in
// the tile and their ds is 0, so both operands of the edge rows are zero,
// as K9 zeroes them (:355-364).
#include "common.cuh"

// the launch arguments, field for field ops/flash_attention.py::_HmArgs
struct HmArgs {
  const void *q, *k, *v, *kvm;
  void* o;
  const void* dO;
  void* lse;
  const void* delta;
  void *dq, *dk, *dv;
  float* ws;
  int B, H, Nq, Nk;
  int q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  float qscale, scale;
};

namespace {

using jt::bf16;
using jt::kPad;

constexpr int BR = 64;  // rows a block owns, 16 per warp
constexpr int NB = 64;  // rows of the other side per inner step
static_assert(NB == 4 * 16, "H7's dQ step gives each warp 16 of the tile's q rows");
constexpr float INV_LOG2E = 0.6931471805599453f;

// the [N, C] rows of head h of batch b of a strided operand
__device__ __forceinline__ const bf16* rows(const void* p, const int* s, int b, int h) {
  return static_cast<const bf16*>(p) + (size_t)b * s[0] + (size_t)h * s[1];
}
__device__ __forceinline__ bf16* rows(void* p, const int* s, int b, int h) {
  return static_cast<bf16*>(p) + (size_t)b * s[0] + (size_t)h * s[1];
}

template <int C>
constexpr int fwd_smem() { return 3 * 64 * (C + kPad) * 2 + NB; }
template <int C>
constexpr int dq_smem() { return 2 * BR * (C + kPad) * 2 + NB; }
template <int C, bool MERGED>
constexpr int dkv_smem() {
  return (2 * NB + 2 * BR) * (C + kPad) * 2 + (MERGED ? NB * (BR + kPad) * 2 : 0) + 2 * NB * 4;
}

// H4: o and lse of 64 query rows of one (batch, head); loops over the keys
template <int C, bool MASKED>
__global__ void __launch_bounds__(jt::kThreads) flash_hm_fwd_kernel(const HmArgs a) {
  constexpr int LD = C + kPad;
  bf16* sQ = jt::smem_bf16();
  bf16* sK = sQ + 64 * LD;
  bf16* sV = sK + NB * LD;
  uint8_t* sM = reinterpret_cast<uint8_t*>(sV + NB * LD);  // the key tile's mask (MASKED)

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Nq = a.Nq, Nk = a.Nk;
  const bf16* kb = rows(a.k, a.k_s, b, h);
  const bf16* vb = rows(a.v, a.v_s, b, h);

  // Q tile, pre-scaled by scale*log2e in fp32 and rounded to bf16
  jt::load_tile<C, 64>(sQ, rows(a.q, a.q_s, b, h), a.q_s[2], q0, Nq, a.qscale);
  __syncthreads();
  const int qr = warp * 16 + g;
  uint32_t qa[C / 16][4];
  jt::load_a<C>(qa, sQ, qr, t);

  float acc[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows g and g+8 of this warp's tile: running max, partial denominators
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += NB) {
    __syncthreads();  // every warp is done with the previous K/V tile
    jt::load_tile<C, NB>(sK, kb, a.k_s[2], k0, Nk, 1.f);
    jt::load_tile<C, NB>(sV, vb, a.v_s[2], k0, Nk, 1.f);
    if constexpr (MASKED) {
      const uint8_t* kvm = static_cast<const uint8_t*>(a.kvm);
      if (tid < NB) sM[tid] = k0 + tid < Nk ? kvm[(size_t)b * Nk + k0 + tid] : 0;
    }
    __syncthreads();

    float s[NB / 8][4];
    jt::mm_abt<C, NB>(s, qa, sK, g, t);  // S = Qs K^T (base-2 logits)
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        if (k0 + col >= Nk) {  // ragged kv edge: no weight
          s[nt][j] = s[nt][2 + j] = -INFINITY;
        } else if constexpr (MASKED) {  // masked keys: -1e30 before the row max
          if (!sM[col]) s[nt][j] = s[nt][2 + j] = -1e30f;
        }
      }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 lies in the first tile, so the max is finite from here on
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // the denominator sums the fp32 p; p is rounded to bf16 as the PV operand
    uint32_t pa[NB / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      const float p00 = exp2f(s[nt][0] - m0), p01 = exp2f(s[nt][1] - m0);
      const float p10 = exp2f(s[nt][2] - m1), p11 = exp2f(s[nt][3] - m1);
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      pa[nt / 2][(nt & 1) * 2 + 0] = jt::pack2(__float2bfloat16(p00), __float2bfloat16(p01));
      pa[nt / 2][(nt & 1) * 2 + 1] = jt::pack2(__float2bfloat16(p10), __float2bfloat16(p11));
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int ot = 0; ot < C / 8; ++ot) {
      acc[ot][0] *= alpha0;
      acc[ot][1] *= alpha0;
      acc[ot][2] *= alpha1;
      acc[ot][3] *= alpha1;
    }
    jt::mm_ab<C, NB>(acc, pa, sV, g, t);  // O += P V
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + qr, r1 = r0 + 8;
  bf16* ob = rows(a.o, a.o_s, b, h);
  const size_t ors = a.o_s[2];
#pragma unroll
  for (int ot = 0; ot < C / 8; ++ot) {
    const int col = ot * 8 + 2 * t;
    if (r0 < Nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * ors + col) =
          __floats2bfloat162_rn(acc[ot][0] / l0, acc[ot][1] / l0);
    if (r1 < Nq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * ors + col) =
          __floats2bfloat162_rn(acc[ot][2] / l1, acc[ot][3] / l1);
  }
  if (t == 0) {
    float* lrow = static_cast<float*>(a.lse) + ((size_t)b * a.H + h) * Nq;
    if (r0 < Nq) lrow[r0] = m0 + log2f(l0);
    if (r1 < Nq) lrow[r1] = m1 + log2f(l1);
  }
}

// H5: dq of 64 q rows of one (batch, head); loops over the kv tiles
template <int C, bool MASKED>
__global__ void __launch_bounds__(jt::kThreads) flash_hm_dq_kernel(const HmArgs a) {
  constexpr int LD = C + kPad;
  bf16* sK = jt::smem_bf16();  // they stage Q and dO first
  bf16* sV = sK + BR * LD;
  uint8_t* sM = reinterpret_cast<uint8_t*>(sV + BR * LD);  // the kv tile's mask (MASKED)

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Nq = a.Nq, Nk = a.Nk;
  const bf16* kb = rows(a.k, a.k_s, b, h);
  const bf16* vb = rows(a.v, a.v_s, b, h);

  // Qs and dO fragments of this warp's 16 q rows
  jt::load_tile<C, BR>(sK, rows(a.q, a.q_s, b, h), a.q_s[2], q0, Nq, a.qscale);
  jt::load_tile<C, BR>(sV, rows(a.dO, a.do_s, b, h), a.do_s[2], q0, Nq, 1.f);
  __syncthreads();
  const int qr = warp * 16 + g;
  uint32_t qa[C / 16][4], da[C / 16][4];
  jt::load_a<C>(qa, sK, qr, t);
  jt::load_a<C>(da, sV, qr, t);
  const int r0 = q0 + qr, r1 = r0 + 8;
  const float* lrow = static_cast<const float*>(a.lse) + ((size_t)b * a.H + h) * Nq;
  const float* drow = static_cast<const float*>(a.delta) + ((size_t)b * a.H + h) * Nq;
  const float L0 = r0 < Nq ? lrow[r0] : 0.f, L1 = r1 < Nq ? lrow[r1] : 0.f;
  const float D0 = r0 < Nq ? drow[r0] : 0.f, D1 = r1 < Nq ? drow[r1] : 0.f;

  float dq[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += NB) {
    __syncthreads();
    jt::load_tile<C, NB>(sK, kb, a.k_s[2], k0, Nk, 1.f);
    jt::load_tile<C, NB>(sV, vb, a.v_s[2], k0, Nk, 1.f);
    if constexpr (MASKED) {
      const uint8_t* kvm = static_cast<const uint8_t*>(a.kvm);
      if (tid < NB) sM[tid] = k0 + tid < Nk ? kvm[(size_t)b * Nk + k0 + tid] : 0;
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
        const int col = nt * 8 + 2 * t + j;
        const bool ok = k0 + col < Nk;
        if constexpr (MASKED) {
          if (!sM[col]) s[nt][j] = s[nt][2 + j] = -1e30f;
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

  jt::store_rows<C>(rows(a.dq, a.dq_s, b, h), a.dq_s[2], r0, Nq, dq, a.scale, t);
}

// H6 (MERGED false): dk, dv of 64 kv rows of one (batch, head), looping
// over the q tiles. H7 (MERGED true): the same plus this block's partial
// dQ = dS K, stored in its k-block's slab of the fp32 workspace a.ws.
template <int C, bool MASKED, bool MERGED>
__global__ void __launch_bounds__(jt::kThreads) flash_hm_dkv_kernel(const HmArgs a) {
  constexpr int LD = C + kPad, LDS = BR + kPad;
  bf16* sQ = jt::smem_bf16();
  bf16* sdO = sQ + NB * LD;
  bf16* sK = sdO + NB * LD;
  bf16* sV = sK + BR * LD;
  bf16* sdS = sV + BR * LD;  // MERGED: dS [NB q rows][BR kv rows]
  float* sL = reinterpret_cast<float*>(sdS + (MERGED ? NB * LDS : 0));
  float* sD = sL + NB;

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Nq = a.Nq, Nk = a.Nk;
  const bf16* qb = rows(a.q, a.q_s, b, h);
  const bf16* dob = rows(a.dO, a.do_s, b, h);
  const float* lrow = static_cast<const float*>(a.lse) + ((size_t)b * a.H + h) * Nq;
  const float* drow = static_cast<const float*>(a.delta) + ((size_t)b * a.H + h) * Nq;
  const int kr = warp * 16 + g;

  // K and V of this block's kv rows, read from shared memory at every step
  // (K is also the B operand of H7's dQ); rows past Nk are zero
  jt::load_tile<C, BR>(sK, rows(a.k, a.k_s, b, h), a.k_s[2], k0, Nk, 1.f);
  jt::load_tile<C, BR>(sV, rows(a.v, a.v_s, b, h), a.v_s[2], k0, Nk, 1.f);
  // this thread's kv rows k0 + kr and k0 + kr + 8: masked or past Nk ones
  // get s = -1e30, so p = ds = 0 on them
  bool valid0 = k0 + kr < Nk, valid1 = k0 + kr + 8 < Nk;
  if constexpr (MASKED) {
    const uint8_t* mrow = static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk;
    valid0 = valid0 && mrow[k0 + kr];
    valid1 = valid1 && mrow[k0 + kr + 8];
  }

  float dk[C / 8][4], dv[C / 8][4];
#pragma unroll
  for (int i = 0; i < C / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < Nq; q0 += NB) {
    __syncthreads();  // every warp is done with the previous tiles
    jt::load_tile<C, NB>(sQ, qb, a.q_s[2], q0, Nq, a.qscale);
    jt::load_tile<C, NB>(sdO, dob, a.do_s[2], q0, Nq, 1.f);
    for (int i = tid; i < NB; i += jt::kThreads) {
      const bool ok = q0 + i < Nq;
      sL[i] = ok ? lrow[q0 + i] : 0.f;
      sD[i] = ok ? drow[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[NB / 8][4], dpt[NB / 8][4];
    jt::mm_abt_s<C, NB>(st, sK, kr, sQ, g, t);    // S^T  = K Qs^T (base-2 logits)
    jt::mm_abt_s<C, NB>(dpt, sV, kr, sdO, g, t);  // dP^T = V dO^T

    uint32_t pa[NB / 16][4], dsa[NB / 16][4];
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      float p[4];
      bf16 ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        const bool ok = q0 + col < Nq;
        const float L = sL[col], D = sD[col];
        if (!valid0) st[nt][j] = -1e30f;
        if (!valid1) st[nt][2 + j] = -1e30f;
        p[j] = ok ? exp2f(st[nt][j] - L) : 0.f;          // kv row g
        p[2 + j] = ok ? exp2f(st[nt][2 + j] - L) : 0.f;  // kv row g + 8
        ds[j] = __float2bfloat16(p[j] * (dpt[nt][j] - D));
        ds[2 + j] = __float2bfloat16(p[2 + j] * (dpt[nt][2 + j] - D));
        if constexpr (MERGED) {  // dS, transposed: row = q, column = kv
          sdS[col * LDS + kr] = ds[j];
          sdS[col * LDS + kr + 8] = ds[2 + j];
        }
      }
      const int kk = nt / 2, hi = (nt & 1) * 2;
      pa[kk][hi] = jt::pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
      pa[kk][hi + 1] = jt::pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
      dsa[kk][hi] = jt::pack2(ds[0], ds[1]);
      dsa[kk][hi + 1] = jt::pack2(ds[2], ds[3]);
    }
    jt::mm_ab<C, NB>(dv, pa, sdO, g, t);  // dV += P^T dO
    jt::mm_ab<C, NB>(dk, dsa, sQ, g, t);  // dK += dS^T Qs

    if constexpr (MERGED) {  // dQ[q rows] += dS K over this block's kv rows
      __syncthreads();       // every warp's dS is in sdS
      uint32_t sa[BR / 16][4];
      jt::load_a<BR>(sa, sdS, warp * 16 + g, t);  // this warp's 16 q rows
      float dqp[C / 8][4];
#pragma unroll
      for (int i = 0; i < C / 8; ++i) dqp[i][0] = dqp[i][1] = dqp[i][2] = dqp[i][3] = 0.f;
      jt::mm_ab<C, BR>(dqp, sa, sK, g, t);
      const int r0 = q0 + warp * 16 + g;
      float* ws = a.ws + (((size_t)blockIdx.x * a.B + b) * a.H + h) * Nq * C;
#pragma unroll
      for (int ot = 0; ot < C / 8; ++ot) {
        const int col = ot * 8 + 2 * t;
        if (r0 < Nq)
          *reinterpret_cast<float2*>(ws + (size_t)r0 * C + col) =
              make_float2(dqp[ot][0], dqp[ot][1]);
        if (r0 + 8 < Nq)
          *reinterpret_cast<float2*>(ws + (size_t)(r0 + 8) * C + col) =
              make_float2(dqp[ot][2], dqp[ot][3]);
      }
    }
  }

  jt::store_rows<C>(rows(a.dk, a.dk_s, b, h), a.dk_s[2], k0 + kr, Nk, dk, INV_LOG2E, t);
  jt::store_rows<C>(rows(a.dv, a.dv_s, b, h), a.dv_s[2], k0 + kr, Nk, dv, 1.f, t);
}

// H7's second pass: dq = bf16(scale * the k-block slabs summed in order),
// one thread per pair of columns
template <int C>
__global__ void __launch_bounds__(jt::kThreads) flash_hm_dq_finish_kernel(const HmArgs a) {
  const size_t pairs = (size_t)a.B * a.H * a.Nq * (C / 2), slab = 2 * pairs;
  const int nkb = (a.Nk + BR - 1) / BR;
  for (size_t i = blockIdx.x * (size_t)jt::kThreads + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * jt::kThreads) {
    const int c2 = (int)(i % (C / 2));
    const size_t row = i / (C / 2);  // (b * H + h) * Nq + n
    const int n = (int)(row % a.Nq), bh = (int)(row / a.Nq);
    float2 v = make_float2(0.f, 0.f);
    for (int kb = 0; kb < nkb; ++kb) {
      const float2 p = *reinterpret_cast<const float2*>(a.ws + kb * slab + row * C + 2 * c2);
      v.x += p.x;
      v.y += p.y;
    }
    bf16* out = rows(a.dq, a.dq_s, bh / a.H, bh % a.H) + (size_t)n * a.dq_s[2] + 2 * c2;
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v.x * a.scale, v.y * a.scale);
  }
}

dim3 grid_of(const HmArgs& a, int rows_per_block, int n) {
  return dim3((n + rows_per_block - 1) / rows_per_block, a.H, a.B);
}

template <int C>
int launch_fwd(const HmArgs* a, void* stream) {
  return jt::launch(a->kvm ? flash_hm_fwd_kernel<C, true> : flash_hm_fwd_kernel<C, false>,
                    grid_of(*a, 64, a->Nq), jt::kThreads, fwd_smem<C>(), stream, *a);
}

template <int C>
int launch_dq(const HmArgs* a, void* stream) {
  return jt::launch(a->kvm ? flash_hm_dq_kernel<C, true> : flash_hm_dq_kernel<C, false>,
                    grid_of(*a, BR, a->Nq), jt::kThreads, dq_smem<C>(), stream, *a);
}

template <int C>
int launch_dkv(const HmArgs* a, void* stream) {
  return jt::launch(
      a->kvm ? flash_hm_dkv_kernel<C, true, false> : flash_hm_dkv_kernel<C, false, false>,
      grid_of(*a, BR, a->Nk), jt::kThreads, dkv_smem<C, false>(), stream, *a);
}

template <int C>
int launch_dqkv(const HmArgs* a, void* stream) {
  const int err = jt::launch(
      a->kvm ? flash_hm_dkv_kernel<C, true, true> : flash_hm_dkv_kernel<C, false, true>,
      grid_of(*a, BR, a->Nk), jt::kThreads, dkv_smem<C, true>(), stream, *a);
  if (err) return err;
  const size_t pairs = (size_t)a->B * a->H * a->Nq * (C / 2);
  const size_t blocks = (pairs + jt::kThreads - 1) / jt::kThreads;
  return jt::launch(flash_hm_dq_finish_kernel<C>, dim3(blocks < 2112 ? blocks : 2112),
                    jt::kThreads, 0, stream, *a);  // at most 16 blocks an SM, then a grid-stride loop
}

}  // namespace

#define JT_HM_ENTRIES(C)                                                       \
  extern "C" int jt_flash_hm_fwd_c##C(const HmArgs* a, void* stream) {         \
    return launch_fwd<C>(a, stream);                                           \
  }                                                                            \
  extern "C" int jt_flash_hm_dq_c##C(const HmArgs* a, void* stream) {          \
    return launch_dq<C>(a, stream);                                            \
  }                                                                            \
  extern "C" int jt_flash_hm_dkv_c##C(const HmArgs* a, void* stream) {         \
    return launch_dkv<C>(a, stream);                                           \
  }                                                                            \
  extern "C" int jt_flash_hm_dqkv_c##C(const HmArgs* a, void* stream) {        \
    return launch_dqkv<C>(a, stream);                                          \
  }

JT_HM_ENTRIES(32)
JT_HM_ENTRIES(64)
