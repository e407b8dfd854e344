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
// bytes of each 64-key stage, so pads anywhere in the row are handled. The
// mask is a template flag.
//
// Rounding points of the reference kernels: q * (scale*log2e) is rounded
// to bf16 before QK^T; p = exp2(s - lse) is fp32, rounded to bf16 only as
// the operand of dV = p^T do; ds = p * (dp - delta) is rounded to bf16
// before dK = ds^T q and dQ = ds k; dk is scaled by 1/log2e and dq by
// `scale` after the sums. Ragged N: q rows past N get p = ds = 0 in the
// dk/dv kernel and kv columns past N get ds = 0 in the dq kernel (TMA
// fills rows past N with zeros, and a zero row scores s = 0, which is no
// zero weight: the guards stay).
//
// What bounds it on the H100: per (batch, head) the backward needs five
// N x N x C products (S, dP, dV, dK, dQ; the split recomputes S and dP in
// both kernels, seven in all) against ~N*C*2*6 bytes of operands, so it
// is compute-bound at the training shapes: the tensor cores, and at C=32
// the exp2 unit (one exp2 per score against 64-160 flops).
//
// Design (Hopper, H1's shape, csrc/flash_attention.cu): a block owns 128
// rows of one (batch, head) with three warpgroups. The producer warpgroup
// (setmaxnreg down) issues TMA loads from 3-D maps over qkv (B, N, 3HC),
// do (B, N, HC) into a ring of stages guarded by mbarriers; each consumer
// warpgroup (setmaxnreg up) owns 64 of the block's rows and runs every
// product as wgmma from swizzled shared memory, with the score and
// gradient tiles kept in registers as the next product's A operand. The
// box is one swizzle row wide, as in H1: C=64 and C=128 64-column boxes in
// the 128-byte swizzle, C=32 one and C=96 three 32-column boxes in the
// 64-byte swizzle, C=80 five 16-column boxes in the 32-byte swizzle. The epilogue scales
// the fp32 accumulators, writes bf16 into the block's own rows of its
// shared tiles in the same swizzle and stores them through a TMA map of
// dqkv (rows past N dropped by the hardware).
//
//   dq kernel: the block's Q and dO rows arrive once; each consumer scales
//   its Q rows by scale*log2e in place (fence.proxy.async before wgmma
//   reads them); 64-key K and V stages stream. S = Qs K^T and dP = dO V^T
//   by wgmma m64n64k16 (both operands K-major as stored), ds in registers,
//   dQ += dS K by wgmma m64nCk16 with dS from registers and K MN-major
//   through the descriptor's transpose bit.
//
//   dk/dv kernel: the block's K and V rows arrive once; Q and dO stream in
//   64-row stages (32 at C=96 and C=128, where dK and dV alone hold 96 and
//   128 fp32 registers a thread), with the stage's lse and delta rows. The producer
//   warpgroup scales each Q stage by scale*log2e in place before it
//   releases the stage to the consumers, so both kernels read one Qs.
//   S^T = K Qs^T and dP^T = V dO^T by wgmma (K-major as stored), p and ds
//   in registers, dV += P^T dO and dK += dS^T Qs by wgmma with dO and Qs
//   MN-major.
//
// Numerics against the mma.sync kernels this design replaced: every
// output is one fp32 accumulator chain of k16 tensor-core steps in the
// same order (dK, dV over the q rows ascending; dQ over the keys
// ascending; S, dP and their transposes over the head dim), with the same
// exp2f and roundings, so the outputs are the same bits (chip_smoke.py
// --kernel-ab). A merged backward that adds per-block dQ partials would
// sum in another order; that is why the two kernels stay split.
#include "common.cuh"

namespace {

using jt::bf16;

constexpr int BR = 128;           // rows a block owns: two consumer warpgroups x 64
constexpr int WG = 128;           // threads of a warpgroup
constexpr int THREADS = 3 * WG;   // two consumer warpgroups, then the producer
constexpr int STAGES = 3;
constexpr int DQ_BKV = 64;        // keys per dq stage
constexpr float INV_LOG2E = 0.6931471805599453f;

// a head dim's TMA box: CB columns, one swizzle row of RB = 2*CB bytes, NB
// boxes across the head; a tile of `rows` rows holds NB column blocks of
// rows*RB bytes each
template <int C>
struct Geo {
  static constexpr int CB = C == 32 || C == 96 ? 32 : C == 80 ? 16 : 64;
  static_assert(C % CB == 0, "the box width must divide the head dim");
  static constexpr int NB = C / CB;
  static constexpr int RB = 2 * CB;
  static constexpr int SWZ = RB == 128 ? jt::kSwizzle128 : RB == 64 ? jt::kSwizzle64 : jt::kSwizzle32;
  static constexpr int SWZ_MASK = RB / 16 - 1;  // row bits XORed into the 16-byte chunk
  // the byte offset of k16 step kk along the head dim in a K-major tile
  __device__ static constexpr int koff(int kk, int rows) {
    return (kk / (CB / 16)) * rows * RB + (kk % (CB / 16)) * 32;
  }
  // a K-major operand (rows of the tile, the head dim contracted)
  __device__ static uint64_t kdesc(const unsigned char* tile, int kk, int rows) {
    return jt::make_desc(tile + koff(kk, rows), 16, 8 * RB, SWZ);
  }
  // an MN-major operand (the tile's rows contracted from row 16*kk, the
  // head dim across)
  __device__ static uint64_t mndesc(const unsigned char* tile, int kk, int rows) {
    return jt::make_desc(tile + kk * 16 * RB, rows * RB, 8 * RB, SWZ);
  }
};

// q rows per dk/dv stage
template <int C>
constexpr int kStep = C > 80 ? 32 : 64;

template <int C>
constexpr int dq_smem() {
  return 2 * BR * 2 * C + STAGES * 2 * DQ_BKV * 2 * C + 8 * (1 + 2 * STAGES) + 1024;
}
template <int C>
constexpr int dkv_smem() {
  return 2 * BR * 2 * C + STAGES * 2 * kStep<C> * (2 * C + 4) + 8 * (1 + 3 * STAGES) + 1024;
}

// Qs: a warpgroup's share of a tile scaled by scale*log2e in fp32 and
// rounded to bf16, in place (elementwise, so the swizzle is kept)
__device__ __forceinline__ void scale_in_place(unsigned char* p, int bytes, int tid, float qscale) {
  for (int v = tid; v < bytes / 16; v += WG) {
    uint4* q = reinterpret_cast<uint4*>(p + v * 16);
    uint4 val = *q;
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
    *q = val;
  }
}

// a warpgroup's 64 x C fp32 accumulator times `mul` as bf16 into its rows
// of a 128-row tile (`mine` points at its first row), in the TMA map's
// swizzle (the 16-byte chunk index XOR the row's low bits)
template <int C>
__device__ __forceinline__ void store_smem(unsigned char* mine, const float (&acc)[C / 2],
                                           float mul, int warp, int g, int t) {
  using G = Geo<C>;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = (r0 + 8 * half) * G::RB + (col % G::CB) * 2;
      const int phys = off ^ (((off >> 7) & G::SWZ_MASK) << 4);
      *reinterpret_cast<__nv_bfloat162*>(mine + (col / G::CB) * BR * G::RB + phys) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
    }
  }
}

// 128 rows from row r0 of columns [col, col + C) of a 3-D map (64-row
// boxes) into a 128-row tile
template <int C>
__device__ __forceinline__ void load_rows128(unsigned char* tile, const CUtensorMap* map,
                                             uint64_t* bar, int col, int r0, int b) {
  using G = Geo<C>;
  for (int i = 0; i < G::NB; ++i)
    for (int r = 0; r < 2; ++r)
      jt::tma_load_3d(tile + i * BR * G::RB + r * 64 * G::RB, map, bar, col + i * G::CB,
                      r0 + 64 * r, b);
}

// dq of 128 q rows of one (batch, head); streams every kv stage
template <int C, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tqkv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdqkv, const uint8_t* __restrict__ kvm,
                    const float* __restrict__ lse, const float* __restrict__ delta, int N, int H,
                    float qscale, float scale) {
  using G = Geo<C>;
  constexpr int TQ = BR * 2 * C, TK = DQ_BKV * 2 * C;
  unsigned char* smem = jt::smem_1024();
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + TQ;
  unsigned char* sKV = sdO + TQ;  // stage s: K at 2s tiles, V at 2s + 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sKV + 2 * STAGES * TK);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int HC = H * C;
  const int nkv = (N + DQ_BKV - 1) / DQ_BKV;

  if (threadIdx.x == 0) {
    jt::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      jt::mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      jt::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    jt::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    jt::reg_dealloc<40>();
    if (tid == 0) {
      jt::mbar_expect_tx(qbar, 2 * TQ);
      load_rows128<C>(sQ, &tqkv, qbar, h * C, q0, b);
      load_rows128<C>(sdO, &tdo, qbar, h * C, q0, b);
      for (int it = 0; it < nkv; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) jt::mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        unsigned char* sk = sKV + 2 * s * TK;
        jt::mbar_expect_tx(&full[s], 2 * TK);
        for (int i = 0; i < G::NB; ++i) {
          const int col = h * C + i * G::CB;
          jt::tma_load_3d(sk + i * DQ_BKV * G::RB, &tqkv, &full[s], HC + col, it * DQ_BKV, b);
          jt::tma_load_3d(sk + TK + i * DQ_BKV * G::RB, &tqkv, &full[s], 2 * HC + col,
                          it * DQ_BKV, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + [64 wg, 64 wg + 64)
    jt::reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    unsigned char* myq = sQ + wg * 64 * G::RB;
    const unsigned char* mydo = sdO + wg * 64 * G::RB;
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    const float* lrow = lse + ((size_t)b * H + h) * N;
    const float* drow = delta + ((size_t)b * H + h) * N;
    const float L0 = r0 < N ? lrow[r0] : 0.f, L1 = r1 < N ? lrow[r1] : 0.f;
    const float D0 = r0 < N ? drow[r0] : 0.f, D1 = r1 < N ? drow[r1] : 0.f;

    jt::mbar_wait(qbar, 0);
    for (int i = 0; i < G::NB; ++i) scale_in_place(myq + i * BR * G::RB, 64 * G::RB, tid, qscale);
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, WG);

    float dq[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) dq[i] = 0.f;

    for (int it = 0; it < nkv; ++it) {
      const int s = it % STAGES, k0 = it * DQ_BKV;
      const unsigned char* sk = sKV + 2 * s * TK;
      const unsigned char* sv = sk + TK;
      // the stage's key mask, read before the wait: lane l loads keys 2l
      // and 2l+1; this thread's keys 8j + 2t + e sit in ballot e at bit 4j + t
      uint32_t bal[2] = {~0u, ~0u};
      if constexpr (MASKED) {
        const uint8_t* mrow = kvm + (size_t)b * N + k0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 2 * lane + e;
          bal[e] = __ballot_sync(0xffffffffu, k0 + key < N && mrow[key]);
        }
      }
      jt::mbar_wait(&full[s], (it / STAGES) & 1);

      // S = Qs K^T (base-2 logits) and dP = dO V^T, 64 x 64 per warpgroup
      float sc[DQ_BKV / 2], dp[DQ_BKV / 2];
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(sc, G::kdesc(myq, kk, BR), G::kdesc(sk, kk, DQ_BKV), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(dp, G::kdesc(mydo, kk, BR), G::kdesc(sv, kk, DQ_BKV), kk > 0);
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(sc);
      jt::fence_regs(dp);

      uint32_t dsa[DQ_BKV / 16][4];
#pragma unroll
      for (int j = 0; j < DQ_BKV / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = k0 + 8 * j + 2 * t + e < N;
          if constexpr (MASKED) {
            if (!((bal[e] >> (4 * j + t)) & 1u)) sc[4 * j + e] = sc[4 * j + 2 + e] = -1e30f;
          }
          ds[e] = ok ? exp2f(sc[4 * j + e] - L0) * (dp[4 * j + e] - D0) : 0.f;
          ds[2 + e] = ok ? exp2f(sc[4 * j + 2 + e] - L1) * (dp[4 * j + 2 + e] - D1) : 0.f;
        }
        dsa[j / 2][(j & 1) * 2] = jt::pack2(__float2bfloat16(ds[0]), __float2bfloat16(ds[1]));
        dsa[j / 2][(j & 1) * 2 + 1] = jt::pack2(__float2bfloat16(ds[2]), __float2bfloat16(ds[3]));
      }
      // dQ += dS K, K MN-major (keys down, the head's columns across)
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk)
        jt::wgmma_rs<1>(dq, dsa[kk], G::mndesc(sk, kk, DQ_BKV), 1);
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(dq);
      jt::keep_regs(dsa);
      if (lane == 0) jt::mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

    store_smem<C>(myq, dq, scale, warp, g, t);
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, WG);
    if (tid == 0 && q0 + wg * 64 < N) {
      for (int i = 0; i < G::NB; ++i)
        jt::tma_store_3d(&tdqkv, myq + i * BR * G::RB, h * C + i * G::CB, q0 + wg * 64, b);
      jt::tma_store_commit_and_wait();
    }
  }
}

// dk, dv of 128 kv rows of one (batch, head); streams every q stage
template <int C, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tkv, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tdqkv,
                     const uint8_t* __restrict__ kvm, const float* __restrict__ lse,
                     const float* __restrict__ delta, int N, int H, float qscale) {
  using G = Geo<C>;
  constexpr int STEP = kStep<C>;
  constexpr int TK = BR * 2 * C, TQ = STEP * 2 * C;
  unsigned char* smem = jt::smem_1024();
  unsigned char* sK = smem;
  unsigned char* sV = sK + TK;
  unsigned char* sQD = sV + TK;  // stage s: Qs at 2s tiles, dO at 2s + 1
  float* sLD = reinterpret_cast<float*>(sQD + 2 * STAGES * TQ);  // stage s: lse, delta rows
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sLD + 2 * STAGES * STEP);
  uint64_t* loaded = kvbar + 1;
  uint64_t* full = loaded + STAGES;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int HC = H * C;
  const int nq = (N + STEP - 1) / STEP;

  if (threadIdx.x == 0) {
    jt::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      jt::mbar_init(&loaded[s], 1);  // the TMA bytes of the stage's Q and dO
      jt::mbar_init(&full[s], WG);   // every producer thread: Q scaled, lse and delta in
      jt::mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    jt::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: loads, and scales each Q stage in place
    jt::reg_dealloc<56>();
    if (tid == 0) {
      jt::mbar_expect_tx(kvbar, 2 * TK);
      load_rows128<C>(sK, &tkv, kvbar, HC + h * C, k0, b);
      load_rows128<C>(sV, &tkv, kvbar, 2 * HC + h * C, k0, b);
    }
    const float* lrow = lse + ((size_t)b * H + h) * N;
    const float* drow = delta + ((size_t)b * H + h) * N;
    for (int it = 0; it < nq; ++it) {
      const int s = it % STAGES, q0 = it * STEP;
      if (it >= STAGES) jt::mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
      unsigned char* sq = sQD + 2 * s * TQ;
      if (tid == 0) {
        jt::mbar_expect_tx(&loaded[s], 2 * TQ);
        for (int i = 0; i < G::NB; ++i) {
          jt::tma_load_3d(sq + i * STEP * G::RB, &tq, &loaded[s], h * C + i * G::CB, q0, b);
          jt::tma_load_3d(sq + TQ + i * STEP * G::RB, &tdo, &loaded[s], h * C + i * G::CB, q0, b);
        }
      }
      float* sl = sLD + 2 * s * STEP;
      for (int i = tid; i < STEP; i += WG) {
        const bool ok = q0 + i < N;
        sl[i] = ok ? lrow[q0 + i] : 0.f;
        sl[STEP + i] = ok ? drow[q0 + i] : 0.f;
      }
      jt::mbar_wait(&loaded[s], (it / STAGES) & 1);
      scale_in_place(sq, TQ, tid, qscale);
      jt::fence_proxy_async();
      jt::mbar_arrive(&full[s]);
    }
  } else {  // consumers: warpgroup wg owns kv rows k0 + [64 wg, 64 wg + 64)
    jt::reg_alloc<224>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    unsigned char* myk = sK + wg * 64 * G::RB;
    unsigned char* myv = sV + wg * 64 * G::RB;
    // this thread's kv rows: masked (or past N) ones get s = -1e30
    [[maybe_unused]] bool valid0 = true, valid1 = true;
    if constexpr (MASKED) {
      const int kr = k0 + wg * 64 + warp * 16 + g;
      const uint8_t* mrow = kvm + (size_t)b * N;
      valid0 = kr < N && mrow[kr];
      valid1 = kr + 8 < N && mrow[kr + 8];
    }
    jt::mbar_wait(kvbar, 0);

    float dk[C / 2], dv[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) dk[i] = dv[i] = 0.f;

    for (int it = 0; it < nq; ++it) {
      const int s = it % STAGES, q0 = it * STEP;
      const unsigned char* sq = sQD + 2 * s * TQ;
      const unsigned char* sd = sq + TQ;
      const float* sl = sLD + 2 * s * STEP;
      jt::mbar_wait(&full[s], (it / STAGES) & 1);

      // S^T = K Qs^T (base-2 logits) and dP^T = V dO^T, 64 x STEP per warpgroup
      float st[STEP / 2], dpt[STEP / 2];
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(st, G::kdesc(myk, kk, BR), G::kdesc(sq, kk, STEP), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(dpt, G::kdesc(myv, kk, BR), G::kdesc(sd, kk, STEP), kk > 0);
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(st);
      jt::fence_regs(dpt);

      uint32_t pa[STEP / 16][4], dsa[STEP / 16][4];
#pragma unroll
      for (int j = 0; j < STEP / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const bool ok = q0 + col < N;
          const float L = sl[col], D = sl[STEP + col];
          if constexpr (MASKED) {
            if (!valid0) st[4 * j + e] = -1e30f;
            if (!valid1) st[4 * j + 2 + e] = -1e30f;
          }
          p[e] = ok ? exp2f(st[4 * j + e] - L) : 0.f;          // kv row g
          p[2 + e] = ok ? exp2f(st[4 * j + 2 + e] - L) : 0.f;  // kv row g + 8
          ds[e] = p[e] * (dpt[4 * j + e] - D);
          ds[2 + e] = p[2 + e] * (dpt[4 * j + 2 + e] - D);
        }
        pa[j / 2][(j & 1) * 2] = jt::pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
        pa[j / 2][(j & 1) * 2 + 1] = jt::pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
        dsa[j / 2][(j & 1) * 2] = jt::pack2(__float2bfloat16(ds[0]), __float2bfloat16(ds[1]));
        dsa[j / 2][(j & 1) * 2 + 1] = jt::pack2(__float2bfloat16(ds[2]), __float2bfloat16(ds[3]));
      }
      // dV += P^T dO and dK += dS^T Qs, dO and Qs MN-major (q rows down)
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEP / 16; ++kk)
        jt::wgmma_rs<1>(dv, pa[kk], G::mndesc(sd, kk, STEP), 1);
#pragma unroll
      for (int kk = 0; kk < STEP / 16; ++kk)
        jt::wgmma_rs<1>(dk, dsa[kk], G::mndesc(sq, kk, STEP), 1);
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(dv);
      jt::fence_regs(dk);
      jt::keep_regs(pa);
      jt::keep_regs(dsa);
      if (lane == 0) jt::mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

    store_smem<C>(myk, dk, INV_LOG2E, warp, g, t);
    store_smem<C>(myv, dv, 1.f, warp, g, t);
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, WG);
    if (tid == 0 && k0 + wg * 64 < N) {
      for (int i = 0; i < G::NB; ++i) {
        const int col = h * C + i * G::CB;
        jt::tma_store_3d(&tdqkv, myk + i * BR * G::RB, HC + col, k0 + wg * 64, b);
        jt::tma_store_3d(&tdqkv, myv + i * BR * G::RB, 2 * HC + col, k0 + wg * 64, b);
      }
      jt::tma_store_commit_and_wait();
    }
  }
}

// host: a 3-D TMA map over a token-major [B, N, width] bf16 tensor, boxes
// of one swizzle row's columns x `rows` rows
template <int C>
int tm_map(CUtensorMap* map, const void* p, uint64_t width, int N, int B, int rows) {
  const uint64_t dims[3] = {width, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {width * 2, width * 2 * N};
  const uint32_t box[3] = {Geo<C>::CB, (uint32_t)rows, 1};
  return jt::make_tensor_map(map, p, 3, dims, strides, box, Geo<C>::SWZ);
}

// kvm == nullptr launches the unmasked instances
template <int C>
int launch_dkv(const void* qkv, const void* kvm, const void* dO, const void* lse,
               const void* delta, void* dqkv, int B, int N, int H, float qscale,
               void* stream) {
  const uint64_t hc = (uint64_t)H * C;
  CUtensorMap tkv, tq, tdo, tdqkv;
  int err = tm_map<C>(&tkv, qkv, 3 * hc, N, B, 64);
  if (!err) err = tm_map<C>(&tq, qkv, 3 * hc, N, B, kStep<C>);
  if (!err) err = tm_map<C>(&tdo, dO, hc, N, B, kStep<C>);
  if (!err) err = tm_map<C>(&tdqkv, dqkv, 3 * hc, N, B, 64);
  if (err) return err;
  const dim3 grid((N + BR - 1) / BR, H, B);
  return jt::launch(kvm ? flash_bwd_dkv_kernel<C, true> : flash_bwd_dkv_kernel<C, false>,
                    grid, THREADS, dkv_smem<C>(), stream, tkv, tq, tdo, tdqkv,
                    (const uint8_t*)kvm, (const float*)lse, (const float*)delta, N, H, qscale);
}

template <int C>
int launch_dq(const void* qkv, const void* kvm, const void* dO, const void* lse,
              const void* delta, void* dqkv, int B, int N, int H, float qscale,
              float scale, void* stream) {
  const uint64_t hc = (uint64_t)H * C;
  CUtensorMap tqkv, tdo, tdqkv;
  int err = tm_map<C>(&tqkv, qkv, 3 * hc, N, B, 64);
  if (!err) err = tm_map<C>(&tdo, dO, hc, N, B, 64);
  if (!err) err = tm_map<C>(&tdqkv, dqkv, 3 * hc, N, B, 64);
  if (err) return err;
  const dim3 grid((N + BR - 1) / BR, H, B);
  return jt::launch(kvm ? flash_bwd_dq_kernel<C, true> : flash_bwd_dq_kernel<C, false>,
                    grid, THREADS, dq_smem<C>(), stream, tqkv, tdo, tdqkv, (const uint8_t*)kvm,
                    (const float*)lse, (const float*)delta, N, H, qscale, scale);
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
JT_BWD_ENTRIES(96)
JT_BWD_ENTRIES(128)
