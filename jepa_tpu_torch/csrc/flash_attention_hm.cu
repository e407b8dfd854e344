// H4-H7: head-major flash attention, forward and backward, bf16.
//
// Replaces the head-major TPU kernels of jepa_tpu/ops/flash_attention.py:
//   H4 flash_hm_fwd_kernel                 <- _fwd_kernel   (K6, :122)
//   H5 flash_hm_dq_kernel                  <- _dq_kernel    (K7, :225)
//   H6 flash_hm_bwd_kernel                 <- _dkv_kernel   (K8, :254)
//   H7 flash_hm_bwd_kernel (kDQ) and
//      flash_hm_dq_finish_kernel           <- _dqkv_kernel  (K9, :318)
// All four are one Hopper design: a producer warpgroup issues TMA loads
// from 4-D maps of each operand into an mbarrier ring, two consumer
// warpgroups run every product by wgmma, and the outputs leave by TMA
// stores (H7's dq by its second pass). They serve flash_attention_bhnd /
// flash_attention_packed / flash_attention (ops/flash_attention.py), which
// the port reaches from dot_product_attention(impl='flash') and from
// flash_self_attention where no token-major head split exists (vit_tiny's
// 3 heads of 64).
//
// Operands: q [B, H, Nq, C], k, v [B, H, Nk, C] and the other [B, H, N, C]
// tensors are read and written by (batch, head, row) strides with a
// contiguous head dim (HmArgs), so the three planes of a packed
// [3, B, H, N, C] qkv, or a permuted view of the token-major projection
// [B, N, 3*H*C], are used in place. lse and delta are [B, H, Nq] fp32; the
// optional key mask kvm is [B, Nk] uint8 (1 = valid), a template flag: the
// JAX package's row mask [B, 8, Nk] (K6, K7) and column mask [B, Nk, 8]
// (K8, K9) are both this one array. C in {16, 32, 64}.
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
// tensor cores and the exp2 unit.
//
// H4's design (Hopper, H1's shape with head-major addresses and K6's
// denominator): a block takes 128 query rows of one (batch, head) with
// three warpgroups. The producer warpgroup (setmaxnreg down to 40) has one
// thread issue TMA loads from 4-D maps over (C, N, H, B), one per operand
// with its own byte strides, so a permuted view or a packed plane is read
// in place and rows past N come back as zeros, never as the next head's
// rows: the Q tile once, then 128-key K and V tiles into a 3-stage ring,
// each stage guarded by a full and an empty mbarrier. The box is the whole
// head row: C=64 in the 128-byte swizzle, C=32 in the 64-byte swizzle,
// C=16 in the 32-byte swizzle (FwdGeo).
// Each consumer warpgroup (232 registers) owns 64 query rows: it scales
// its Q rows by scale*log2e in fp32 in place (fence.proxy.async before
// wgmma reads them), takes S = Q K^T by wgmma m64n128k16 from shared
// memory, and runs the online softmax on the accumulator fragment one
// 64-key half at a time: O += P V (wgmma m64nCk16, P from registers, V
// MN-major through the descriptor's transpose bit) runs for the first
// half while the second half's max, p and l are computed. The epilogue
// divides by max(l, 1e-30), writes bf16 O into the warpgroup's rows of
// the Q tile in the same swizzle and stores them through a 4-D map of o;
// lse goes out directly.
//
// Numerics of H4 against the mma.sync kernel it replaced: the running max
// moves every 64 keys, p = exp2f(s - m) (not the flushing ex2), each thread
// sums its unrounded p in the m16n8k16 fragment order, l = l*alpha + rs,
// then across the row's four threads; O is rescaled once per 64 keys and
// every product is a chain of k16 tensor-core steps in the same order. So
// its outputs are the same bits (chip_smoke.py --kernel-ab).
//
// H5's design (Hopper): H2's dq kernel (csrc/flash_attention_bwd.cu)
// read and written through H4's 4-D maps. A block owns 128 q rows of one
// (batch, head) with three warpgroups; the grid runs over Nq, the stages
// over Nk. The producer warpgroup (setmaxnreg down to 40) loads the
// block's lse and delta rows (0 past Nq), one row a thread, and arrives on
// the 128-arrival Q barrier; one thread issues the Q and dO tiles once
// (128-row boxes), then 64-key K and V stages into a 3-stage ring, each
// stage guarded by a full and an empty mbarrier. With the key mask, the
// producer's first warp reads each stage's 64 mask bytes and writes them
// as two ballot words before that thread's arrival on the stage. Each
// consumer warpgroup (232 registers) owns 64 q rows: it scales its Q rows
// by scale*log2e in fp32 in place (fence.proxy.async before wgmma reads
// them), then per stage takes S = Qs K^T and dP = dO V^T by wgmma
// m64n64k16 (both K-major as stored, one commit group each), sets a
// masked key's score to -1e30, forms p = exp2f(s - lse) while dP runs and
// ds = p * (dp - delta) in registers (0 for keys past Nk), and adds dQ +=
// dS K by wgmma m64nCk16 with dS from registers and K MN-major through the
// descriptor's transpose bit. That product is retired at the next stage,
// after its S and dP are issued behind it, so the tensor cores run the
// three back to back (1.20x the loop that waited for it, on an H100;
// taking the key guard off the stages below Nk measured slower). The
// epilogue writes bf16 scale*dq into the warpgroup's rows of the Q tile in
// the same swizzle and stores them through a 4-D map of dq (rows past Nq
// dropped), so the dq plane of a packed dqkv is written in place. Shared
// memory at C=64: 16 KB Q, 16 KB dO and 3 x 16 KB of K/V stages. Numerics
// against the mma.sync kernel it replaced: a k16 wgmma step sums as an
// m16n8k16 does, so each dq element is one fp32 chain over the keys
// ascending from 0 in k16 steps, S and dP each one chain over the head
// dim; Qs and ds round to bf16 where that kernel rounded them, with the
// same exp2f, and dq is scaled after the whole sum: the same bits
// (chip_smoke.py --kernel-ab).
//
// H6's design (Hopper): H2's dk/dv kernel (csrc/flash_attention_bwd.cu)
// read and written through H4's 4-D maps. A block owns 128 kv rows of one
// (batch, head) with three warpgroups. The producer warpgroup (setmaxnreg
// down to 56) has one thread issue TMA loads from 4-D maps of q, k, v and
// do built from their own strides: K and V of the block once, then Q and
// dO in 64-row stages over Nq into a 3-stage ring; every producer thread
// loads a share of the stage's lse and delta rows, waits for the stage's
// bytes, scales its share of the Q stage by scale*log2e in fp32 in place,
// rounding to bf16 (the Qs the mma.sync kernel's loader made), and arrives
// on the stage's 128-arrival full barrier. Each consumer warpgroup (224
// registers) owns 64 kv rows: S^T = K Qs^T and dP^T = V dO^T by wgmma
// m64n64k16 (K-major as stored), p = exp2f(s - lse) and ds = p*(dp -
// delta) in registers, dV += P^T dO and dK += dS^T Qs by wgmma m64nCk16
// with P and dS from registers and dO and Qs MN-major (the descriptor's
// transpose bit). The epilogue writes bf16 dk*(1/log2e) and dv into the
// warpgroup's rows of the K and V tiles in the same swizzle and stores
// them through 4-D maps of dk and dv (rows past Nk dropped), so the dk and
// dv planes of a packed dqkv are written in place. The grid runs over Nk,
// the stages over Nq. Numerics: dK and dV over the q rows ascending, S^T
// and dP^T over the head dim, each one chain of k16 tensor-core steps in
// the mma.sync kernel's order, with the same exp2f and roundings: the same
// bits (chip_smoke.py --kernel-ab).
//
// H7, the merged backward (K9), is H6's kernel (flash_hm_bwd_kernel, kDQ)
// plus dQ. Each consumer warpgroup's 64 kv rows are one k-block: after
// the stage's ds it writes its bf16 dS^T fragment (64 kv rows x the
// stage's 64 q) into one of its two shared tiles in the 128-byte swizzle,
// as stored (q contiguous), and dQ_part (64 q x C, fp32) = dS K runs by
// wgmma m64nCk16 from shared memory beside dV and dK, dS^T and K read
// MN-major through A's and B's transpose bits. Several k-blocks write
// every dq row, and Hopper's blocks run in no order (K9 sums them in VMEM
// scratch because the TPU grid runs in order; fp32 atomics made vit_tiny's
// trajectory differ between processes), so each k-block stores its partial
// in its own slab of a workspace [ceil(Nk/64), B, H, Nq, C], and a second
// kernel sums the slabs in k-block order, scales and casts into dq:
// dq = bf16(scale * (((P0 + P1) + P2) + ...)), each P_j one k16 chain over
// its 64 kv rows, as the mma.sync kernel it replaced summed them (the same
// bits). The slabs cost about half of H7's time at vit_tiny's shapes (their
// stores and the second pass). Two ways around them gave the same bits but
// measured slower on an H100: an in-kernel fix-up (the k-block whose
// arrival completes a (batch, head, q stage) count sums that stage's
// slabs while they are in L2; its gpu-scope acquire-release atomic stalled
// a consumer warpgroup every stage), and a thread block cluster of each
// (batch, head)'s blocks summing every stage's partials from each other's
// shared memory, synchronised per stage by remote mbarrier arrivals or by
// the cluster barrier (the producer warpgroup two stages behind): every
// block of a cluster then waits for the slowest each stage, and a block
// holds a whole SM (its registers), so fewer blocks ran at once.
// Masked kv rows and rows past Nk score -1e30, so their ds is 0 and, their
// K rows zero-filled by TMA, both operands of the edge rows are zero, as K9
// zeroes them (:355-364).
//
#include "flash_hm.cuh"

namespace {

using jt::bf16;

constexpr float INV_LOG2E = 0.6931471805599453f;

// H4 geometry: the TMA box is the whole head row (C columns, one swizzle
// row of RB bytes), 128 rows a box
constexpr int FWD_BQ = 128;   // query rows per block: two consumer warpgroups x 64
constexpr int FWD_BKV = 128;  // keys per ring stage: two halves of the running max's 64
constexpr int FWD_WG = 128;   // threads of a warpgroup
constexpr int FWD_THREADS = 3 * FWD_WG;
constexpr int FWD_STAGES = 3;

// H5 geometry: H4's 128 q rows a block and 3-stage ring, 64 keys a stage
constexpr int DQ_BKV = 64;

// H6 geometry: 128 kv rows a block (two consumer warpgroups x 64), q
// stages of 64 rows, boxes as H4's (one swizzle row: the head row)
constexpr int DKV_BR = 128;
constexpr int DKV_STEP = 64;
constexpr int DKV_STAGES = 3;
// H7's dS^T tiles: 64 kv rows of the stage's 64 q columns, bf16, one
// 128-byte swizzle row each
constexpr int DS_RB = DKV_STEP * 2;
constexpr int DS_TILE = 64 * DS_RB;
static_assert(DS_RB == 128, "H7's dS^T tile rows are one 128-byte swizzle row");

// C=16 (vit_small's 96-wide predictor, 6 heads of 16): a 32-byte head row,
// so every product that contracts the head dim (S = Q K^T, dP = dO V^T,
// S^T = K Qs^T, dP^T = V dO^T) is one k16 step, and every product whose N
// is the head dim (O = P V, dQ = dS K, dV = P^T dO, dK = dS^T Qs, H7's
// dQ_part) is m64n16k16; the MN-major operand (V, K, dO, Qs) is then
// exactly one 32-byte swizzle atom wide. The stores' XOR below, (off >> 7)
// & SWZ_MASK into the 16-byte chunk index, is the 32-byte pattern at
// SWZ_MASK = 1 (bit 7 into bit 4).
template <int C>
struct FwdGeo {
  static_assert(C == 16 || C == 32 || C == 64,
                "FwdGeo: the head row is one swizzle row of 32, 64 or 128 bytes");
  static constexpr int RB = 2 * C;
  static constexpr int SWZ = C == 64 ? jt::kSwizzle128 : C == 32 ? jt::kSwizzle64 : jt::kSwizzle32;
  static constexpr int SWZ_MASK = RB / 16 - 1;  // row bits XORed into the 16-byte chunk
  static constexpr int TILE = 128 * RB;
  static constexpr int SMEM = TILE * (1 + 2 * FWD_STAGES) + 8 * (1 + 2 * FWD_STAGES) + 1024;
  // H5: the Q and dO tiles, the K/V ring, the block's lse and delta rows,
  // each stage's two mask words, barriers
  static constexpr int DQ_SMEM = 2 * TILE + FWD_STAGES * 2 * DQ_BKV * RB + 2 * FWD_BQ * 4 +
                                 8 * FWD_STAGES + 8 * (1 + 2 * FWD_STAGES) + 1024;
  // H6: K and V tiles, the Q/dO ring with its lse and delta rows, barriers
  static constexpr int DKV_SMEM = 2 * DKV_BR * RB + DKV_STAGES * 2 * DKV_STEP * (RB + 4) +
                                  8 * (1 + 3 * DKV_STAGES) + 1024;
  // H7: H6's and each consumer warpgroup's two dS^T tiles
  static constexpr int DQKV_SMEM = DKV_SMEM + 4 * DS_TILE;
  // wgmma operands: a K-major tile (its rows, the head dim contracted from
  // column 16*kk), an MN-major tile of `rows` rows (rows contracted from
  // row 16*kk, the head dim across)
  __device__ static uint64_t kdesc(const unsigned char* tile, int kk) {
    return jt::make_desc(tile + kk * 32, 16, 8 * RB, SWZ);
  }
  __device__ static uint64_t mndesc(const unsigned char* tile, int kk, int rows) {
    return jt::make_desc(tile + kk * 16 * RB, rows * RB, 8 * RB, SWZ);
  }
};

// one 64-key half of a stage's scores (fragment columns 8j.., j in [J0,
// J0 + 8)) for rows g and g+8, as K6: the running max (m0, m1) moves to
// the half's, p = exp2f(s - m) in fp32 is rounded to bf16 only into PV's A
// fragments pa[J0/2 ..], and this thread's part of l is rescaled and takes
// the unrounded p in the m16n8k16 fragments' order; returns the factors
// (alpha0, alpha1) that rescale O
template <int J0>
__device__ __forceinline__ float2 hm_softmax_half(const float (&sc)[FWD_BKV / 2], float& m0,
                                                  float& m1, float& l0, float& l1,
                                                  uint32_t (&pa)[FWD_BKV / 16][4]) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = J0; j < J0 + 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // key 0 lies in the first half, so the max is finite from there on
  const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = J0; j < J0 + 8; ++j) {
    const float p00 = exp2f(sc[4 * j] - m0), p01 = exp2f(sc[4 * j + 1] - m0);
    const float p10 = exp2f(sc[4 * j + 2] - m1), p11 = exp2f(sc[4 * j + 3] - m1);
    rs0 += p00 + p01;
    rs1 += p10 + p11;
    pa[j / 2][(j & 1) * 2 + 0] = jt::pack2(__float2bfloat16(p00), __float2bfloat16(p01));
    pa[j / 2][(j & 1) * 2 + 1] = jt::pack2(__float2bfloat16(p10), __float2bfloat16(p11));
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
  return make_float2(alpha0, alpha1);
}

// H4: o and lse of 128 query rows of one (batch, head); loops over the keys
template <int C, bool MASKED>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_hm_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    const uint8_t* __restrict__ kvm, float* __restrict__ lse, int Nq, int Nk,
                    int H, float qscale) {
  using G = FwdGeo<C>;
  unsigned char* smem = jt::smem_1024();
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + G::TILE;  // stage s: K at 2s tiles, V at 2s + 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sKV + 2 * FWD_STAGES * G::TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + FWD_STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * FWD_BQ;
  const int wg = threadIdx.x / FWD_WG, tid = threadIdx.x % FWD_WG;
  const int nkv = (Nk + FWD_BKV - 1) / FWD_BKV;

  if (threadIdx.x == 0) {
    jt::mbar_init(qbar, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      jt::mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      jt::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    jt::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread issues every load
    jt::reg_dealloc<40>();
    if (tid == 0) {
      jt::mbar_expect_tx(qbar, G::TILE);
      jt::tma_load_4d(sQ, &tq, qbar, 0, q0, h, b);
      for (int it = 0; it < nkv; ++it) {
        const int s = it % FWD_STAGES;
        if (it >= FWD_STAGES) jt::mbar_wait(&empty[s], ((it / FWD_STAGES) + 1) & 1);
        unsigned char* sk = sKV + 2 * s * G::TILE;
        jt::mbar_expect_tx(&full[s], 2 * G::TILE);
        jt::tma_load_4d(sk, &tk, &full[s], 0, it * FWD_BKV, h, b);
        jt::tma_load_4d(sk + G::TILE, &tv, &full[s], 0, it * FWD_BKV, h, b);
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + [64 wg, 64 wg + 64)
    jt::reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    unsigned char* myq = sQ + wg * 64 * G::RB;  // this warpgroup's rows of the Q tile

    // Q pre-scaled by scale*log2e in fp32 and rounded to bf16, in place
    jt::mbar_wait(qbar, 0);
    for (int v = tid; v < 64 * G::RB / 16; v += FWD_WG) {
      uint4* p = reinterpret_cast<uint4*>(myq + v * 16);
      uint4 val = *p;
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
      *p = val;
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, FWD_WG);

    float o[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
    // rows g and g+8 of this warp's 16: running max, and this thread's part
    // of the denominators
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int it = 0; it < nkv; ++it) {
      const int s = it % FWD_STAGES, k0 = it * FWD_BKV;
      const unsigned char* sk = sKV + 2 * s * G::TILE;
      const unsigned char* sv = sk + G::TILE;
      // the tile's key mask, read before the wait: lane l loads keys 4l..4l+3
      // and four ballots give the warp every key's bit (key k: bit k/4 of
      // word k%4); this thread's keys 8j + 2t + e sit in word 2(t&1) + e
      // at bit 2j + t/2
      uint32_t mw0 = 0, mw1 = 0;
      if constexpr (MASKED) {
        const uint8_t* mrow = kvm + (size_t)b * Nk + k0;
        uint32_t bal[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 4 * lane + i;
          bal[i] = __ballot_sync(0xffffffffu, k0 + key < Nk && mrow[key]);
        }
        mw0 = (t & 1) ? bal[2] : bal[0];
        mw1 = (t & 1) ? bal[3] : bal[1];
      }
      jt::mbar_wait(&full[s], (it / FWD_STAGES) & 1);

      // S = Q K^T (base-2 logits), 64 x 128 per warpgroup
      float sc[FWD_BKV / 2];
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(sc, jt::make_desc(myq + kk * 32, 16, 8 * G::RB, G::SWZ),
                           jt::make_desc(sk + kk * 32, 16, 8 * G::RB, G::SWZ), kk > 0);
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(sc);

      if constexpr (MASKED) {  // masked keys: -1e30 before the row max
#pragma unroll
        for (int j = 0; j < FWD_BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(((e ? mw1 : mw0) >> (2 * j + (t >> 1))) & 1u))
              sc[4 * j + e] = sc[4 * j + 2 + e] = -1e30f;
      }
      if (k0 + FWD_BKV > Nk) {  // ragged kv edge: keys past Nk get no weight
#pragma unroll
        for (int j = 0; j < FWD_BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + 2 * t + e >= Nk) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
      }

      // the first 64 keys: max, p and l, O rescaled, then its P V in flight
      uint32_t pa[FWD_BKV / 16][4];
      float2 a = hm_softmax_half<0>(sc, m0, m1, l0, l1, pa);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        o[4 * j] *= a.x;
        o[4 * j + 1] *= a.x;
        o[4 * j + 2] *= a.y;
        o[4 * j + 3] *= a.y;
      }
      // O += P V, V MN-major (keys down, the head's columns across)
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BKV / 32; ++kk)
        jt::wgmma_rs<1>(o, pa[kk], jt::make_desc(sv + kk * 16 * G::RB, G::TILE, 8 * G::RB, G::SWZ), 1);
      jt::wgmma_commit();
      if (k0 + FWD_BKV / 2 < Nk) {  // the second 64 keys hold a key below Nk
        a = hm_softmax_half<FWD_BKV / 16>(sc, m0, m1, l0, l1, pa);
        jt::wgmma_wait<0>();
        jt::fence_regs(o);
        jt::keep_regs(pa);
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          o[4 * j] *= a.x;
          o[4 * j + 1] *= a.x;
          o[4 * j + 2] *= a.y;
          o[4 * j + 3] *= a.y;
        }
        jt::wgmma_fence();
#pragma unroll
        for (int kk = FWD_BKV / 32; kk < FWD_BKV / 16; ++kk)
          jt::wgmma_rs<1>(o, pa[kk], jt::make_desc(sv + kk * 16 * G::RB, G::TILE, 8 * G::RB, G::SWZ), 1);
        jt::wgmma_commit();
      }
      jt::wgmma_wait<0>();
      jt::fence_regs(o);
      jt::keep_regs(pa);
      if (lane == 0) jt::mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the row's four threads
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    // O / l as bf16 into this warpgroup's rows of the Q tile, in the TMA
    // map's swizzle (the 16-byte chunk index XOR the row's low bits)
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (r0 + 8 * half) * G::RB + col * 2;
        const int phys = off ^ (((off >> 7) & G::SWZ_MASK) << 4);
        const float l = half ? l1 : l0;
        *reinterpret_cast<__nv_bfloat162*>(myq + phys) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] / l, o[4 * j + 2 * half + 1] / l);
      }
    }
    if (t == 0) {
      float* lrow = lse + ((size_t)b * H + h) * Nq;
      const int row = q0 + wg * 64 + r0;
      if (row < Nq) lrow[row] = m0 + log2f(l0);
      if (row + 8 < Nq) lrow[row + 8] = m1 + log2f(l1);
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, FWD_WG);
    if (tid == 0 && q0 + wg * 64 < Nq) {
      jt::tma_store_4d(&to, myq, 0, q0 + wg * 64, h, b);
      jt::tma_store_commit_and_wait();
    }
  }
}

// H5: dq of 128 q rows of one (batch, head); streams every 64-key stage
template <int C, bool MASKED>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_hm_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tdq, const uint8_t* __restrict__ kvm,
                   const float* __restrict__ lse, const float* __restrict__ delta, int Nq, int Nk,
                   int H, float qscale, float scale) {
  using G = FwdGeo<C>;
  constexpr int TK = DQ_BKV * G::RB;
  unsigned char* smem = jt::smem_1024();
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + G::TILE;
  unsigned char* sKV = sdO + G::TILE;  // stage s: K at 2s tiles, V at 2s + 1
  float* sLD = reinterpret_cast<float*>(sKV + 2 * FWD_STAGES * TK);  // lse, then delta rows
  uint32_t* sMW = reinterpret_cast<uint32_t*>(sLD + 2 * FWD_BQ);    // stage s: mask words 2s, 2s+1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sMW + 2 * FWD_STAGES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + FWD_STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * FWD_BQ;
  const int wg = threadIdx.x / FWD_WG, tid = threadIdx.x % FWD_WG;
  const int nkv = (Nk + DQ_BKV - 1) / DQ_BKV;

  if (threadIdx.x == 0) {
    jt::mbar_init(qbar, FWD_WG);  // every producer thread: its lse and delta row; the TMA bytes
    for (int s = 0; s < FWD_STAGES; ++s) {
      jt::mbar_init(&full[s], 1);   // the producer's arrive (after the mask words) + the TMA bytes
      jt::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    jt::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup
    jt::reg_dealloc<40>();
    // the block's lse and delta rows (0 past Nq), one row a thread
    const size_t bh = (size_t)b * H + h;
    const bool ok = q0 + tid < Nq;
    sLD[tid] = ok ? lse[bh * Nq + q0 + tid] : 0.f;
    sLD[FWD_BQ + tid] = ok ? delta[bh * Nq + q0 + tid] : 0.f;
    if (tid == 0) {
      jt::mbar_expect_tx(qbar, 2 * G::TILE);
      jt::tma_load_4d(sQ, &tq, qbar, 0, q0, h, b);
      jt::tma_load_4d(sdO, &tdo, qbar, 0, q0, h, b);
    } else {
      jt::mbar_arrive(qbar);
    }
    // the K/V ring (thread 0) and, masked, each stage's key mask as two
    // ballot words (warp 0): lane l reads keys 2l and 2l+1, so key
    // 8j + 2t + e sits in word e at bit 4j + t
    if (MASKED ? tid < 32 : tid == 0) {
      const uint8_t* mrow = MASKED ? kvm + (size_t)b * Nk : nullptr;
      for (int it = 0; it < nkv; ++it) {
        const int s = it % FWD_STAGES, k0 = it * DQ_BKV;
        if (it >= FWD_STAGES) jt::mbar_wait(&empty[s], ((it / FWD_STAGES) + 1) & 1);
        if constexpr (MASKED) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 2 * tid + e;
            const uint32_t w = __ballot_sync(0xffffffffu, key < Nk && mrow[key]);
            if (tid == 0) sMW[2 * s + e] = w;
          }
        }
        if (tid == 0) {  // the words are written before this arrival
          unsigned char* sk = sKV + 2 * s * TK;
          jt::mbar_expect_tx(&full[s], 2 * TK);
          jt::tma_load_4d(sk, &tk, &full[s], 0, k0, h, b);
          jt::tma_load_4d(sk + TK, &tv, &full[s], 0, k0, h, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + [64 wg, 64 wg + 64)
    jt::reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    unsigned char* myq = sQ + wg * 64 * G::RB;
    const unsigned char* mydo = sdO + wg * 64 * G::RB;

    // Qs: q * (scale*log2e) in fp32, rounded to bf16, in place
    jt::mbar_wait(qbar, 0);
    for (int v = tid; v < 64 * G::RB / 16; v += FWD_WG) {
      uint4* p = reinterpret_cast<uint4*>(myq + v * 16);
      uint4 val = *p;
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
      *p = val;
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, FWD_WG);
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows r0, r0 + 8 of the block
    const float L0 = sLD[r0], L1 = sLD[r0 + 8];
    const float D0 = sLD[FWD_BQ + r0], D1 = sLD[FWD_BQ + r0 + 8];

    float dq[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) dq[i] = 0.f;
    // the previous stage's dS, the A operand of its dQ product, which runs
    // while this stage's S and dP are issued behind it
    uint32_t dsa[DQ_BKV / 16][4] = {};

    for (int it = 0; it < nkv; ++it) {
      const int s = it % FWD_STAGES, k0 = it * DQ_BKV;
      const unsigned char* sk = sKV + 2 * s * TK;
      const unsigned char* sv = sk + TK;
      jt::mbar_wait(&full[s], (it / FWD_STAGES) & 1);
      uint32_t mw[2] = {~0u, ~0u};
      if constexpr (MASKED) {
        mw[0] = sMW[2 * s];
        mw[1] = sMW[2 * s + 1];
      }

      // S = Qs K^T (base-2 logits) and dP = dO V^T, 64 x 64 per warpgroup,
      // in two groups: the exp2 of S runs while dP is computed
      float sc[DQ_BKV / 2], dp[DQ_BKV / 2];
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(sc, G::kdesc(myq, kk), G::kdesc(sk, kk), kk > 0);
      jt::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(dp, G::kdesc(mydo, kk), G::kdesc(sv, kk), kk > 0);
      jt::wgmma_commit();
      jt::wgmma_wait<1>();  // the previous stage's dQ product and S are done
      jt::fence_regs(dq);
      jt::fence_regs(sc);
      jt::keep_regs(dsa);
      if (it > 0 && lane == 0) jt::mbar_arrive(&empty[(it - 1) % FWD_STAGES]);

      // p = exp2f(s - lse) in place; a masked key scores -1e30
#pragma unroll
      for (int j = 0; j < DQ_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (MASKED) {
            if (!((mw[e] >> (4 * j + t)) & 1u)) sc[4 * j + e] = sc[4 * j + 2 + e] = -1e30f;
          }
          sc[4 * j + e] = exp2f(sc[4 * j + e] - L0);
          sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - L1);
        }
      jt::wgmma_wait<0>();
      jt::fence_regs(dp);

      // ds = p * (dp - delta), 0 for a key past Nk
#pragma unroll
      for (int j = 0; j < DQ_BKV / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = k0 + 8 * j + 2 * t + e < Nk;
          ds[e] = ok ? sc[4 * j + e] * (dp[4 * j + e] - D0) : 0.f;
          ds[2 + e] = ok ? sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - D1) : 0.f;
        }
        dsa[j / 2][(j & 1) * 2] = jt::pack2(__float2bfloat16(ds[0]), __float2bfloat16(ds[1]));
        dsa[j / 2][(j & 1) * 2 + 1] = jt::pack2(__float2bfloat16(ds[2]), __float2bfloat16(ds[3]));
      }
      // dQ += dS K, K MN-major (keys down, the head's columns across); the
      // next stage's wait retires it
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk)
        jt::wgmma_rs<1>(dq, dsa[kk], G::mndesc(sk, kk, DQ_BKV), 1);
      jt::wgmma_commit();
    }
    jt::wgmma_wait<0>();
    jt::fence_regs(dq);
    jt::keep_regs(dsa);

    // dq * scale as bf16 into this warpgroup's rows of the Q tile, in the
    // TMA map's swizzle (the 16-byte chunk index XOR the row's low bits)
    const int w0 = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (w0 + 8 * half) * G::RB + col * 2;
        const int phys = off ^ (((off >> 7) & G::SWZ_MASK) << 4);
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(myq + phys) =
            __floats2bfloat162_rn(dq[i] * scale, dq[i + 1] * scale);
      }
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, FWD_WG);
    if (tid == 0 && q0 + wg * 64 < Nq) {
      jt::tma_store_4d(&tdq, myq, 0, q0 + wg * 64, h, b);
      jt::tma_store_commit_and_wait();
    }
  }
}

// H6 (kDQ = false): dk, dv of 128 kv rows of one (batch, head), streaming
// every q stage. H7 (kDQ = true): the same, and each consumer warpgroup's
// dQ partial over its 64 kv rows (k-block blockIdx.x * 2 + wg), stored in
// that k-block's slab of the fp32 workspace ws [ceil(Nk/64), B, H, Nq, C].
template <int C, bool MASKED, bool kDQ>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_hm_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                    const uint8_t* __restrict__ kvm, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ ws, int Nq, int Nk, int H,
                    int B, float qscale) {
  using G = FwdGeo<C>;
  constexpr int STEP = DKV_STEP, STAGES = DKV_STAGES;
  constexpr int TK = DKV_BR * G::RB, TQ = STEP * G::RB;
  unsigned char* smem = jt::smem_1024();
  unsigned char* sK = smem;
  unsigned char* sV = sK + TK;
  unsigned char* sQD = sV + TK;  // stage s: Qs at 2s tiles, dO at 2s + 1
  // H7: each consumer warpgroup's two dS^T tiles [64 kv][64 q] (128-byte rows)
  unsigned char* sDS = sQD + 2 * STAGES * TQ;
  float* sLD = reinterpret_cast<float*>(sDS + (kDQ ? 4 * DS_TILE : 0));  // stage s: lse, delta
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sLD + 2 * STAGES * STEP);
  uint64_t* loaded = kvbar + 1;
  uint64_t* full = loaded + STAGES;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * DKV_BR;
  const int wg = threadIdx.x / FWD_WG, tid = threadIdx.x % FWD_WG;
  const int nq = (Nq + STEP - 1) / STEP;

  if (threadIdx.x == 0) {
    jt::mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      jt::mbar_init(&loaded[s], 1);     // the TMA bytes of the stage's Q and dO
      jt::mbar_init(&full[s], FWD_WG);  // every producer thread: Q scaled, lse and delta in
      jt::mbar_init(&empty[s], 8);      // one arrive per consumer warp
    }
    jt::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: loads, and scales each Q stage in place
    jt::reg_dealloc<56>();
    if (tid == 0) {
      jt::mbar_expect_tx(kvbar, 2 * TK);
      for (int r = 0; r < 2; ++r) {  // 64-row boxes: each consumer warpgroup's rows
        jt::tma_load_4d(sK + r * 64 * G::RB, &tk, kvbar, 0, k0 + 64 * r, h, b);
        jt::tma_load_4d(sV + r * 64 * G::RB, &tv, kvbar, 0, k0 + 64 * r, h, b);
      }
    }
    const float* lrow = lse + ((size_t)b * H + h) * Nq;
    const float* drow = delta + ((size_t)b * H + h) * Nq;
    for (int it = 0; it < nq; ++it) {
      const int s = it % STAGES, q0 = it * STEP;
      if (it >= STAGES) jt::mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
      unsigned char* sq = sQD + 2 * s * TQ;
      if (tid == 0) {
        jt::mbar_expect_tx(&loaded[s], 2 * TQ);
        jt::tma_load_4d(sq, &tq, &loaded[s], 0, q0, h, b);
        jt::tma_load_4d(sq + TQ, &tdo, &loaded[s], 0, q0, h, b);
      }
      float* sl = sLD + 2 * s * STEP;
      for (int i = tid; i < STEP; i += FWD_WG) {
        const bool ok = q0 + i < Nq;
        sl[i] = ok ? lrow[q0 + i] : 0.f;
        sl[STEP + i] = ok ? drow[q0 + i] : 0.f;
      }
      jt::mbar_wait(&loaded[s], (it / STAGES) & 1);
      // Qs: q * (scale*log2e) in fp32, rounded to bf16, in place
      for (int v = tid; v < TQ / 16; v += FWD_WG) {
        uint4* p = reinterpret_cast<uint4*>(sq + v * 16);
        uint4 val = *p;
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
        *p = val;
      }
      jt::fence_proxy_async();
      jt::mbar_arrive(&full[s]);
    }
  } else {  // consumers: warpgroup wg owns kv rows k0 + [64 wg, 64 wg + 64)
    jt::reg_alloc<224>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    unsigned char* myk = sK + wg * 64 * G::RB;
    unsigned char* myv = sV + wg * 64 * G::RB;
    const int kr = k0 + wg * 64 + warp * 16 + g;  // this thread's kv rows kr, kr + 8
    // masked kv rows get s = -1e30, so p = ds = 0 on them; H7 also so
    // treats rows past Nk (zero K rows, whose dS enters dQ), as K9 does
    [[maybe_unused]] bool valid0 = !kDQ || kr < Nk, valid1 = !kDQ || kr + 8 < Nk;
    if constexpr (MASKED) {
      const uint8_t* mrow = kvm + (size_t)b * Nk;
      valid0 = kr < Nk && mrow[kr];
      valid1 = kr + 8 < Nk && mrow[kr + 8];
    }
    // H7: this warpgroup's k-block, and its slab of ws; a warpgroup whose
    // rows all lie past Nk has no slab (the second pass sums
    // ceil(Nk/64) of them)
    const int kb = blockIdx.x * 2 + wg;
    const bool dq_part = kDQ && kb * 64 < Nk;
    float* slab = dq_part ? ws + (((size_t)kb * B + b) * H + h) * Nq * C : nullptr;
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
        jt::wgmma_ss<0, 0>(st, G::kdesc(myk, kk), G::kdesc(sq, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        jt::wgmma_ss<0, 0>(dpt, G::kdesc(myv, kk), G::kdesc(sd, kk), kk > 0);
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
          const bool ok = q0 + col < Nq;
          const float L = sl[col], D = sl[STEP + col];
          if constexpr (MASKED || kDQ) {
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
      // H7: dS^T as stored rows (kv) of q columns into this stage's tile, in
      // the 128-byte swizzle; the tile two stages back was read by a product
      // every warp of the warpgroup has waited for
      [[maybe_unused]] unsigned char* sds = sDS + (2 * wg + (it & 1)) * DS_TILE;
      if constexpr (kDQ) {
        if (dq_part) {
#pragma unroll
          for (int j = 0; j < STEP / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int off = (warp * 16 + g + 8 * half) * DS_RB + (8 * j + 2 * t) * 2;
              *reinterpret_cast<uint32_t*>(sds + (off ^ (((off >> 7) & 7) << 4))) =
                  dsa[j / 2][(j & 1) * 2 + half];
            }
          jt::fence_proxy_async();
          jt::bar_sync(1 + wg, FWD_WG);  // the whole tile is written before wgmma reads it
        }
      }
      // dV += P^T dO and dK += dS^T Qs, dO and Qs MN-major (q rows down);
      // H7: dQ_part = dS K over this warpgroup's 64 kv rows, dS^T and K
      // MN-major (A's and B's transpose bits)
      [[maybe_unused]] float dqp[C / 2];
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEP / 16; ++kk)
        jt::wgmma_rs<1>(dv, pa[kk], G::mndesc(sd, kk, STEP), 1);
#pragma unroll
      for (int kk = 0; kk < STEP / 16; ++kk)
        jt::wgmma_rs<1>(dk, dsa[kk], G::mndesc(sq, kk, STEP), 1);
      if constexpr (kDQ) {
        if (dq_part) {
#pragma unroll
          for (int kk = 0; kk < 64 / 16; ++kk)
            jt::wgmma_ss<1, 1>(dqp, jt::make_desc(sds + kk * 16 * DS_RB, 64 * DS_RB, 8 * DS_RB,
                                                  jt::kSwizzle128),
                               G::mndesc(myk, kk, 64), kk > 0);
        }
      }
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(dv);
      jt::fence_regs(dk);
      jt::keep_regs(pa);
      jt::keep_regs(dsa);
      if (lane == 0) jt::mbar_arrive(&empty[s]);  // this warp is done with the stage
      if constexpr (kDQ) {
        if (dq_part) {  // the partial's q rows below Nq into the slab
          jt::fence_regs(dqp);
          const int r0 = q0 + warp * 16 + g;
#pragma unroll
          for (int j = 0; j < C / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (r0 + 8 * half < Nq)
                *reinterpret_cast<float2*>(slab + (size_t)(r0 + 8 * half) * C + 8 * j + 2 * t) =
                    make_float2(dqp[4 * j + 2 * half], dqp[4 * j + 2 * half + 1]);
        }
      }
    }

    // dk / log2e and dv as bf16 into this warpgroup's rows of the K and V
    // tiles, in the TMA maps' swizzle (the 16-byte chunk index XOR the
    // row's low bits)
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (r0 + 8 * half) * G::RB + col * 2;
        const int phys = off ^ (((off >> 7) & G::SWZ_MASK) << 4);
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(myk + phys) =
            __floats2bfloat162_rn(dk[i] * INV_LOG2E, dk[i + 1] * INV_LOG2E);
        *reinterpret_cast<__nv_bfloat162*>(myv + phys) = __floats2bfloat162_rn(dv[i], dv[i + 1]);
      }
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, FWD_WG);
    if (tid == 0 && k0 + wg * 64 < Nk) {
      jt::tma_store_4d(&tdk, myk, 0, k0 + wg * 64, h, b);
      jt::tma_store_4d(&tdv, myv, 0, k0 + wg * 64, h, b);
      jt::tma_store_commit_and_wait();
    }
  }
}

dim3 grid_of(const HmArgs& a, int rows_per_block, int n) {
  return dim3((n + rows_per_block - 1) / rows_per_block, a.H, a.B);
}

// host: a 4-D TMA map (C, n, H, B) over one [B, H, n, C] operand read by
// its (batch, head, row) element strides, boxes of `rows` rows x C
template <int C>
int hm_map(CUtensorMap* map, const void* p, const int* s, int n, const HmArgs& a, int rows) {
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)n, (uint64_t)a.H, (uint64_t)a.B};
  const uint64_t strides[3] = {2 * (uint64_t)s[2], 2 * (uint64_t)s[1], 2 * (uint64_t)s[0]};
  const uint32_t box[4] = {(uint32_t)C, (uint32_t)rows, 1, 1};
  return jt::make_tensor_map(map, p, 4, dims, strides, box, FwdGeo<C>::SWZ);
}

// H4's maps (Q, K and V boxes of 128 rows, o of 64: one warpgroup's rows),
// then the launch; kvm == nullptr launches the unmasked instance
template <int C>
int launch_fwd(const HmArgs* a, void* stream) {
  CUtensorMap tq, tk, tv, to;
  int err = hm_map<C>(&tq, a->q, a->q_s, a->Nq, *a, FWD_BQ);
  if (!err) err = hm_map<C>(&tk, a->k, a->k_s, a->Nk, *a, FWD_BKV);
  if (!err) err = hm_map<C>(&tv, a->v, a->v_s, a->Nk, *a, FWD_BKV);
  if (!err) err = hm_map<C>(&to, a->o, a->o_s, a->Nq, *a, 64);
  if (err) return err;
  return jt::launch(a->kvm ? flash_hm_fwd_kernel<C, true> : flash_hm_fwd_kernel<C, false>,
                    grid_of(*a, FWD_BQ, a->Nq), FWD_THREADS, FwdGeo<C>::SMEM, stream, tq, tk, tv,
                    to, (const uint8_t*)a->kvm, (float*)a->lse, a->Nq, a->Nk, a->H, a->qscale);
}

// H5's maps: q and do in 128-row boxes (the block's rows), k and v in
// 64-row boxes (the ring's stages), dq in 64-row boxes (each consumer
// warpgroup's rows)
template <int C>
int launch_dq(const HmArgs* a, void* stream) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = hm_map<C>(&tq, a->q, a->q_s, a->Nq, *a, FWD_BQ);
  if (!err) err = hm_map<C>(&tk, a->k, a->k_s, a->Nk, *a, DQ_BKV);
  if (!err) err = hm_map<C>(&tv, a->v, a->v_s, a->Nk, *a, DQ_BKV);
  if (!err) err = hm_map<C>(&tdo, a->dO, a->do_s, a->Nq, *a, FWD_BQ);
  if (!err) err = hm_map<C>(&tdq, a->dq, a->dq_s, a->Nq, *a, 64);
  if (err) return err;
  return jt::launch(a->kvm ? flash_hm_dq_kernel<C, true> : flash_hm_dq_kernel<C, false>,
                    grid_of(*a, FWD_BQ, a->Nq), FWD_THREADS, FwdGeo<C>::DQ_SMEM, stream, tq, tk,
                    tv, tdo, tdq, (const uint8_t*)a->kvm, (const float*)a->lse,
                    (const float*)a->delta, a->Nq, a->Nk, a->H, a->qscale, a->scale);
}

// H6's and H7's maps: q and do in 64-row boxes (the q stages), k, v, dk
// and dv in 64-row boxes (each consumer warpgroup's rows); H7 then sums
// the k-blocks' dq slabs in order
template <int C, bool kDQ>
int launch_bwd(const HmArgs* a, void* stream) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = hm_map<C>(&tq, a->q, a->q_s, a->Nq, *a, DKV_STEP);
  if (!err) err = hm_map<C>(&tk, a->k, a->k_s, a->Nk, *a, 64);
  if (!err) err = hm_map<C>(&tv, a->v, a->v_s, a->Nk, *a, 64);
  if (!err) err = hm_map<C>(&tdo, a->dO, a->do_s, a->Nq, *a, DKV_STEP);
  if (!err) err = hm_map<C>(&tdk, a->dk, a->dk_s, a->Nk, *a, 64);
  if (!err) err = hm_map<C>(&tdv, a->dv, a->dv_s, a->Nk, *a, 64);
  if (!err)
    err = jt::launch(a->kvm ? flash_hm_bwd_kernel<C, true, kDQ> : flash_hm_bwd_kernel<C, false, kDQ>,
                     grid_of(*a, DKV_BR, a->Nk), FWD_THREADS,
                     kDQ ? FwdGeo<C>::DQKV_SMEM : FwdGeo<C>::DKV_SMEM, stream, tq, tk, tv, tdo,
                     tdk, tdv, (const uint8_t*)a->kvm, (const float*)a->lse,
                     (const float*)a->delta, a->ws, a->Nq, a->Nk, a->H, a->B, a->qscale);
  if (err || !kDQ) return err;
  return launch_dq_finish<C, 64, bf16>(*a, stream);  // one consumer warpgroup's 64 kv rows
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
    return launch_bwd<C, false>(a, stream);                                    \
  }                                                                            \
  extern "C" int jt_flash_hm_dqkv_c##C(const HmArgs* a, void* stream) {        \
    return launch_bwd<C, true>(a, stream);                                     \
  }

JT_HM_ENTRIES(16)
JT_HM_ENTRIES(32)
JT_HM_ENTRIES(64)
