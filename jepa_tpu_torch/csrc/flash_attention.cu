// H1: flash self-attention forward over the fused qkv projection, bf16
// (and, at the end of this file, H1-fp32 for fp32 qkv).
//
// Replaces jepa_tpu/ops/flash_attention.py:_fwd_tm_kernel (the one-shot
// token-major TPU kernel) and computes the same math as its kv-blocked
// sibling _fwd_tm_tiled_kernel (K2's geometry, B=1 N=4608 c=80, runs here).
//
// Head dims C in {32, 64, 80, 96, 128}: 64/80 for the encoders, 32 for the
// predictors' 24 zero-padded to 32 (see ops/flash_attention.py), 96 for
// vit_giant's 88 padded to 96, 128 for vit_tiny's 384-wide predictor (3
// heads) and vit_gigantic's 104 padded to 128.
//
// Inputs: qkv [B, N, 3*H*C] bf16, the projection output read by stride
// (columns q|k|v, each head-major), and an optional key mask kvm [B, N]
// uint8 (1 = valid key; the padded mask mode's pads are 0, anywhere in the
// row). Outputs: o [B, N, H*C] bf16 token-major (the input of attn.proj)
// and lse [B, H, N] fp32 in base-2 units (m + log2 l), kept for the
// backward.
//
// Key mask (the masked instance of _fwd_tm_kernel, its mask_ref branch): a
// masked score is set to -1e30 before the row max, as the TPU kernel does,
// each 128-key tile by its own bytes, so a run of pads in the middle of the
// sequence is handled like a tail. A tile whose keys are all masked gives
// p = 1 against its own max of -1e30, and the first valid key's max then
// scales those terms by exp2(-1e30 - m) = 0. A row with no valid key gets
// the uniform average (the padded mode never makes one). The mask is a
// template flag.
//
// Rounding points mirror the reference: q * (scale*log2e) is rounded to
// bf16 before QK^T; p is rounded to bf16 before PV; the denominator is the
// fp32 sum of the rounded p, taken on the CUDA cores.
//
// Softmax: online row max (FlashAttention-2 form), not the TPU kernel's
// static shift C=64. The two agree within bf16 rounding of p over the
// LayerNorm-bounded logit range; the row max is exact at every range and
// needs no denominator clamp.
//
// Numerics: the running max moves every 64 keys, each thread sums its
// rounded p in the order of the m16n8k16 fragments (then across the row's
// four threads), O is rescaled once per 64 keys, and every product is a
// k16 tensor-core step: the same roundings and sums in the same order as
// the mma.sync kernel this design replaced, so the outputs are the same
// bits (chip_smoke.py --kernel-ab reports max|this - other| against it).
// A running max per 128 keys, or l as P times a ones column on the tensor
// cores, moves what p rounds against or the order of l's sums: every
// output stays within tolerance, but each B=2 update check from the
// trained state (chip_smoke.py, check_b2) becomes a new draw from its
// spread (PERF.md §6).
//
// What bounds it on the H100: at ViT-L (N=1568, H=16, C=64) attention is
// 4*N^2*C flops per head against ~N*C*2*3 bytes, so it is compute-bound;
// the ceiling is the tensor-core rate and, at C=32, the exp2 throughput of
// the softmax (one exp2 per score against 64 flops).
//
// Design (Hopper, FlashAttention-3's shape without its ping-pong): a block
// takes 128 query rows of one (batch, head) with three warpgroups. The
// producer warpgroup (setmaxnreg down to 40 registers) has one thread
// issue TMA loads from a 3-D map over (B, N, 3HC): the Q tile once, then
// 128-key K and V tiles into a 2-stage ring, each stage guarded by a full
// and an empty mbarrier. Rows past N come back as zeros, never as the next
// batch's rows. The box is one swizzle row wide: C=64 and C=128 take
// 64-column boxes in the 128-byte swizzle (two per tile at C=128), C=32
// and C=96 32-column boxes in the 64-byte swizzle (three per tile at
// C=96), C=80 (160-byte rows) five 16-column boxes in the 32-byte swizzle;
// the wgmma descriptors use the matching mode (at C=96 and C=128 the PV
// product's V operand spans the boxes through the descriptor's
// leading-byte offset). Each consumer warpgroup (232 registers) owns 64 query
// rows: it scales its Q rows by scale*log2e in place (elementwise, so the
// swizzle is kept; fence.proxy.async before wgmma reads them), then per
// stage S = Q K^T by wgmma m64n128k16 from shared memory (K K-major as
// stored) and the online softmax on the fp32 accumulator fragment in
// registers, one 64-key half at a time: O += P V by wgmma m64nCk16 with P
// in registers (the score fragment packs pairwise into bf16 A fragments;
// V is read MN-major through the descriptor's transpose bit) runs for the
// first half while the second half's max, p and l are computed; O is then
// rescaled to the second half's max and takes its P V. The epilogue
// divides by l, writes bf16 O into the warpgroup's own rows of the Q tile
// in the same swizzle and stores them by TMA (rows past N dropped by the
// hardware); lse goes out directly.
#include "common.cuh"

namespace {

using jt::bf16;

constexpr int BQ = 128;   // query rows per block: two consumer warpgroups x 64
constexpr int BKV = 128;  // keys per ring stage: two halves of the running max's 64
constexpr int WG = 128;   // threads of a warpgroup
constexpr int FWD_THREADS = 3 * WG;  // two consumer warpgroups, then the producer
constexpr int STAGES = 2;

// a head dim's TMA box: CB columns, one swizzle row of RB = 2*CB bytes; NB
// boxes across the head; 128-row boxes of BOX bytes, tiles of TILE bytes
template <int C>
struct Geo {
  static constexpr int CB = C == 32 || C == 96 ? 32 : C == 80 ? 16 : 64;
  static_assert(C % CB == 0, "the box width must divide the head dim");
  static constexpr int NB = C / CB;
  static constexpr int RB = 2 * CB;
  static constexpr int SWZ = RB == 128 ? jt::kSwizzle128 : RB == 64 ? jt::kSwizzle64 : jt::kSwizzle32;
  static constexpr int SWZ_MASK = RB / 16 - 1;  // row bits XORed into the 16-byte chunk
  static constexpr int BOX = 128 * RB;
  static constexpr int TILE = NB * BOX;
  static constexpr int SMEM = TILE * (1 + 2 * STAGES) + 8 * (1 + 2 * STAGES) + 1024;
};

// one 64-key half of a stage's scores (fragment columns 8j.., j in [J0,
// J0 + 8)) for rows g and g+8: the running max (m0, m1) moves to the
// half's, p is rounded to bf16 into PV's A fragments pa[J0/2 ..], and
// this thread's part of l is rescaled and takes the half's p in the
// m16n8k16 fragments' order; returns the factors (alpha0, alpha1) that
// rescale O
template <int J0>
__device__ __forceinline__ float2 softmax_half(const float (&sc)[BKV / 2], float& m0, float& m1,
                                               float& l0, float& l1, uint32_t (&pa)[BKV / 16][4]) {
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
  const float alpha0 = jt::ex2_ftz(m0 - mx0), alpha1 = jt::ex2_ftz(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  // p rounded to bf16 (a p below 2^-126 flushes to 0: it adds nothing an
  // fp32 l >= 1 or a bf16 o can hold)
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = J0; j < J0 + 8; ++j) {
    const bf16 p00 = __float2bfloat16(jt::ex2_ftz(sc[4 * j] - m0));
    const bf16 p01 = __float2bfloat16(jt::ex2_ftz(sc[4 * j + 1] - m0));
    const bf16 p10 = __float2bfloat16(jt::ex2_ftz(sc[4 * j + 2] - m1));
    const bf16 p11 = __float2bfloat16(jt::ex2_ftz(sc[4 * j + 3] - m1));
    rs0 += __bfloat162float(p00) + __bfloat162float(p01);
    rs1 += __bfloat162float(p10) + __bfloat162float(p11);
    pa[j / 2][(j & 1) * 2 + 0] = jt::pack2(p00, p01);
    pa[j / 2][(j & 1) * 2 + 1] = jt::pack2(p10, p11);
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
  return make_float2(alpha0, alpha1);
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tqkv, const __grid_constant__ CUtensorMap to,
                 const uint8_t* __restrict__ kvm, float* __restrict__ lse, int N, int H,
                 float qscale) {
  using G = Geo<C>;
  unsigned char* smem = jt::smem_1024();
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + G::TILE;  // stage s: K at 2s tiles, V at 2s + 1
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sKV + 2 * STAGES * G::TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int HC = H * C;
  const int nkv = (N + BKV - 1) / BKV;

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
      jt::mbar_expect_tx(qbar, G::TILE);
      for (int i = 0; i < G::NB; ++i)
        jt::tma_load_3d(sQ + i * G::BOX, &tqkv, qbar, h * C + i * G::CB, q0, b);
      for (int it = 0; it < nkv; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) jt::mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        unsigned char* sk = sKV + 2 * s * G::TILE;
        jt::mbar_expect_tx(&full[s], 2 * G::TILE);
        for (int i = 0; i < G::NB; ++i) {
          const int col = h * C + i * G::CB;
          jt::tma_load_3d(sk + i * G::BOX, &tqkv, &full[s], HC + col, it * BKV, b);
          jt::tma_load_3d(sk + G::TILE + i * G::BOX, &tqkv, &full[s], 2 * HC + col, it * BKV, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns query rows q0 + [64 wg, 64 wg + 64)
    jt::reg_alloc<232>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    unsigned char* myq = sQ + wg * 64 * G::RB;  // this warpgroup's rows in each box

    // Q pre-scaled by scale*log2e in fp32 and rounded to bf16, in place
    jt::mbar_wait(qbar, 0);
    for (int i = 0; i < G::NB; ++i) {
      for (int v = tid; v < 64 * G::RB / 16; v += WG) {
        uint4* p = reinterpret_cast<uint4*>(myq + i * G::BOX + v * 16);
        uint4 val = *p;
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
        *p = val;
      }
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, WG);

    float o[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
    // rows g and g+8 of this warp's 16: running max, and this thread's part
    // of the denominators
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int it = 0; it < nkv; ++it) {
      const int s = it % STAGES, k0 = it * BKV;
      const unsigned char* sk = sKV + 2 * s * G::TILE;
      const unsigned char* sv = sk + G::TILE;
      // the tile's key mask, read before the wait: lane l loads keys 4l..4l+3
      // and four ballots give the warp every key's bit (key k: bit k/4 of
      // word k%4); this thread's keys 8j + 2t + e sit in word 2(t&1) + e
      // at bit 2j + t/2
      uint32_t mw0 = 0, mw1 = 0;
      if constexpr (MASKED) {
        const uint8_t* mrow = kvm + (size_t)b * N + k0;
        uint32_t bal[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 4 * lane + i;
          bal[i] = __ballot_sync(0xffffffffu, k0 + key < N && mrow[key]);
        }
        mw0 = (t & 1) ? bal[2] : bal[0];
        mw1 = (t & 1) ? bal[3] : bal[1];
      }
      jt::mbar_wait(&full[s], (it / STAGES) & 1);

      // S = Q K^T (base-2 logits), 64 x 128 per warpgroup
      float sc[BKV / 2];
      jt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const int off = (kk / (G::CB / 16)) * G::BOX + (kk % (G::CB / 16)) * 32;
        jt::wgmma_ss<0, 0>(sc, jt::make_desc(myq + off, 16, 8 * G::RB, G::SWZ),
                           jt::make_desc(sk + off, 16, 8 * G::RB, G::SWZ), kk > 0);
      }
      jt::wgmma_commit();
      jt::wgmma_wait<0>();
      jt::fence_regs(sc);

      if constexpr (MASKED) {  // masked keys: -1e30 before the row max
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(((e ? mw1 : mw0) >> (2 * j + (t >> 1))) & 1u))
              sc[4 * j + e] = sc[4 * j + 2 + e] = -1e30f;
      }
      if (k0 + BKV > N) {  // ragged kv edge: keys past N get no weight
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + 2 * t + e >= N) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
      }

      // the first 64 keys: max, p and l, O rescaled, then its P V in flight
      uint32_t pa[BKV / 16][4];
      float2 a = softmax_half<0>(sc, m0, m1, l0, l1, pa);
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
      for (int kk = 0; kk < BKV / 32; ++kk)
        jt::wgmma_rs<1>(o, pa[kk], jt::make_desc(sv + kk * 16 * G::RB, G::BOX, 8 * G::RB, G::SWZ), 1);
      jt::wgmma_commit();
      if (k0 + BKV / 2 < N) {  // the second 64 keys hold a key below N
        a = softmax_half<BKV / 16>(sc, m0, m1, l0, l1, pa);
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
        for (int kk = BKV / 32; kk < BKV / 16; ++kk)
          jt::wgmma_rs<1>(o, pa[kk], jt::make_desc(sv + kk * 16 * G::RB, G::BOX, 8 * G::RB, G::SWZ), 1);
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
    // O / l as bf16 into this warpgroup's rows of the Q tile, in the TMA
    // map's swizzle (the 16-byte chunk index XOR the row's low bits)
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = (r0 + 8 * half) * G::RB + (col % G::CB) * 2;
        const int phys = off ^ (((off >> 7) & G::SWZ_MASK) << 4);
        const float l = half ? l1 : l0;
        *reinterpret_cast<__nv_bfloat162*>(myq + (col / G::CB) * G::BOX + phys) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] / l, o[4 * j + 2 * half + 1] / l);
      }
    }
    if (t == 0) {
      float* lrow = lse + ((size_t)b * H + h) * N;
      const int row = q0 + wg * 64 + r0;
      if (row < N) lrow[row] = m0 + log2f(l0);
      if (row + 8 < N) lrow[row + 8] = m1 + log2f(l1);
    }
    jt::fence_proxy_async();
    jt::bar_sync(1 + wg, WG);
    if (tid == 0 && q0 + wg * 64 < N) {
      for (int i = 0; i < G::NB; ++i)
        jt::tma_store_3d(&to, myq + i * G::BOX, h * C + i * G::CB, q0 + wg * 64, b);
      jt::tma_store_commit_and_wait();
    }
  }
}

// the TMA maps of qkv [B, N, 3HC] (Q, K and V boxes of 128 rows) and o
// [B, N, HC] (64-row boxes, one warpgroup's rows), then the launch;
// kvm == nullptr launches the unmasked instance
template <int C>
int launch(const void* qkv, const void* kvm, void* o, void* lse, int B, int N, int H,
           float qscale, void* stream) {
  using G = Geo<C>;
  const uint64_t hc = (uint64_t)H * C;
  const uint64_t qdims[3] = {3 * hc, (uint64_t)N, (uint64_t)B};
  const uint64_t qstrides[2] = {3 * hc * 2, 3 * hc * 2 * N};
  const uint64_t odims[3] = {hc, (uint64_t)N, (uint64_t)B};
  const uint64_t ostrides[2] = {hc * 2, hc * 2 * N};
  const uint32_t qbox[3] = {G::CB, BKV, 1}, obox[3] = {G::CB, 64, 1};
  CUtensorMap tqkv, to;
  int err = jt::make_tensor_map(&tqkv, qkv, 3, qdims, qstrides, qbox, G::SWZ);
  if (!err) err = jt::make_tensor_map(&to, o, 3, odims, ostrides, obox, G::SWZ);
  if (err) return err;
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  return jt::launch(kvm ? flash_fwd_kernel<C, true> : flash_fwd_kernel<C, false>, grid,
                    FWD_THREADS, G::SMEM, stream, tqkv, to, (const uint8_t*)kvm, (float*)lse, N,
                    H, qscale);
}

// ---------------------------------------------------------------------------
// H1-fp32: the same forward for fp32 qkv (the frozen evals with
// optimization.use_bfloat16: false), the fp32 instance of _fwd_tm_kernel.
//
// The reference's rounding points are dtype-generic, and for fp32 they are
// no-ops: q * (scale*log2e) stays fp32, QK^T and PV are fp32 products with
// fp32 sums, p stays fp32. Same base-2 online softmax as above.
//
// Head dims 64, 80, 96 and 128 serve the fp32 evals' encoders; 32 (the
// predictors' 24 zero-padded) and 64 also fp32 pretraining (meta.dtype:
// float32), whose backward is csrc/flash_attention_bwd_f32.cu (H2-fp32).
// Key mask (the padded mask mode), a template flag as in H1: each thread
// reads the bytes of its 4 keys of a tile, and a masked key scores -1e30
// before the row max, so it gets p = 0 exactly (a tile whose keys are all
// masked is scaled away by the first valid key's alpha = 0, as above). The
// unmasked instances keep the arithmetic they had before the flag.
//
// What bounds it on the H100: fp32 has no dense tensor-core path (TF32 is
// not fp32), so the 4*N^2*C flops per head run on the CUDA cores (FFMA,
// 66.9 TFLOP/s): at ViT-L (N=1568, C=64) the flops are ~1,000 per byte
// moved, so it is FFMA-bound, and a kernel that feeds every FFMA its
// operands from shared memory one at a time is bound by the shared-memory
// pipe instead.
//
// Design (register-tiled FFMA, as a SIMT GEMM): a block takes 128 query
// rows of one (batch, head) with 256 threads. Thread (rg, cg) of warp w
// (rg = 4w + lane%4, cg = lane/4) owns the 4 query rows 4rg..4rg+3 and,
// per 32-key tile, the keys cg + 8i (i < 4) of S and the head columns
// 32g + 4cg.. (g < C/32) and, at C=80, 64+2cg.. of O, so a row's 8 owners
// sit in one warp. The Q tile, scaled by qscale in fp32, is stored c-major once;
// K (rows padded to C+4 floats, so the 8 column groups' keys fall in 8
// bank groups) and V tiles of 32 keys stream through a 2-stage cp.async
// ring, one __syncthreads a tile. S: per 4 head columns a thread loads 4
// float4 of Qs (its rows) and 4 of K (its keys) for 64 FFMAs. The row max
// over the tile is taken by shuffles among the row's 8 owners; p goes to
// the warp's own [32 keys][16 rows] slice of shared memory (a __syncwarp,
// no block barrier); PV: per key a float4 of p (its rows) and 2-3 loads of
// V for 32-64 FFMAs, and l takes p in key order in each owner (4 adds).
// Head dims 32, 64 and 80 ask for two blocks an SM (128 registers a thread);
// at 96 and 128 the accumulators (48 and 64 a thread) and the shared
// memory (113 and 145 KB a block) leave room for one, so the launch bound
// asks for one and the registers spill nowhere.
//
// Numerics against the one-row-a-thread kernel this design replaced, kept
// to the bit: s = an fmaf chain over c ascending from 0 with q*qscale
// rounded once; the max moves every 32 keys; alpha = exp2f(m - mx); l =
// fmaf(l, alpha, p of the tile's first key) (the contraction the compiler
// made of that kernel's l *= alpha; l += p), then += p in key order; acc =
// acc*alpha, then fmaf(p, v, acc) in key order; o = acc*(1/l), lse = m +
// log2f(l) (chip_smoke.py --kernel-ab).
constexpr int F32_BQ = 128;       // query rows per block, 4 a thread
constexpr int F32_BKV = 32;       // keys per tile: the running max moves every 32 keys
constexpr int F32_THREADS = 256;  // 8 warps of 4 row groups x 8 column groups
constexpr int F32_STAGES = 2;

template <int C>
struct F32Geo {
  static constexpr int KLD = C + 4;              // padded K row, floats
  static constexpr int SQ = C * F32_BQ;          // Qs [C][128]
  static constexpr int SK = F32_BKV * KLD;       // K tile [32][C+4]
  static constexpr int SV = F32_BKV * C;         // V tile [32][C]
  static constexpr int SP = 8 * F32_BKV * 16;    // p, per warp [32 keys][16 rows]
  static constexpr int SMEM = 4 * (SQ + F32_STAGES * (SK + SV) + SP);
  static constexpr int NV = C / 32;              // float4 column groups of O (1-4)
  static constexpr int NT = (C % 32) / 8;        // float2 tail columns of O (0; 2 at C=80)
  static constexpr int COLS = 4 * NV + NT;       // O columns a thread owns
  static constexpr int MINB = C <= 80 ? 2 : 1;   // blocks an SM, for the launch bound
};

// the K and V rows of keys [k0, k0 + 32) into one ring stage
// (rows past N zero-filled); K of head h at column kcol of a qkv row, V
// H*C columns further
template <int C>
__device__ __forceinline__ void f32_load_kv(float* sk, float* sv, const float* base, size_t rs,
                                            int kcol, int HC, int k0, int N, int tid) {
  using G = F32Geo<C>;
  for (int i = tid; i < F32_BKV * C / 4; i += F32_THREADS) {
    const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
    const bool ok = k0 + r < N;
    const float* src = base + (size_t)(ok ? k0 + r : 0) * rs + kcol + c4;
    jt::cp_async16(sk + r * G::KLD + c4, src, ok);
    jt::cp_async16(sv + r * C + c4, src + HC, ok);
  }
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(F32_THREADS, F32Geo<C>::MINB)
flash_fwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ kvm,
                     float* __restrict__ o, float* __restrict__ lse, int N, int H,
                     float qscale) {
  using G = F32Geo<C>;
  float* sQ = reinterpret_cast<float*>(jt::smem_bytes());
  float* sK = sQ + G::SQ;                  // stage s at s * SK
  float* sV = sK + F32_STAGES * G::SK;     // stage s at s * SV
  float* sP = sV + F32_STAGES * G::SV;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * F32_BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = 4 * (4 * warp + rl);  // block row of row 0
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;  // token row stride of qkv
  const float* base = qkv + (size_t)b * N * rs;
  const int nkv = (N + F32_BKV - 1) / F32_BKV;

  f32_load_kv<C>(sK, sV, base, rs, HC + h * C, HC, 0, N, tid);
  jt::cp_async_commit();
  // Qs c-major: column c of the tile's rows at sQ + c * 128
  for (int i = tid; i < F32_BQ * C / 4; i += F32_THREADS) {
    const int r = i % F32_BQ, c4 = 4 * (i / F32_BQ);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N)
      x = *reinterpret_cast<const float4*>(base + (size_t)(q0 + r) * rs + h * C + c4);
    sQ[(c4 + 0) * F32_BQ + r] = x.x * qscale;
    sQ[(c4 + 1) * F32_BQ + r] = x.y * qscale;
    sQ[(c4 + 2) * F32_BQ + r] = x.z * qscale;
    sQ[(c4 + 3) * F32_BQ + r] = x.w * qscale;
  }

  float acc[4][G::COLS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < G::COLS; ++j) acc[r][j] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float* myp = sP + warp * F32_BKV * 16;  // this warp's p: [key][16 rows]

  for (int it = 0; it < nkv; ++it) {
    const int s = it % F32_STAGES, k0 = it * F32_BKV;
    jt::cp_async_wait_all();
    __syncthreads();  // tile it (and Qs) in; every thread is done with tile it - 1
    if (it + 1 < nkv) {
      const int n = (it + 1) % F32_STAGES;
      f32_load_kv<C>(sK + n * G::SK, sV + n * G::SV, base, rs, HC + h * C, HC, k0 + F32_BKV, N,
                     tid);
      jt::cp_async_commit();
    }
    const float* sk = sK + s * G::SK + cg * G::KLD;  // key cg; key cg + 8i at + 8i*KLD
    const float* sv = sV + s * G::SV;
    bool key_ok[4] = {true, true, true, true};  // MASKED: key cg + 8i valid or past N
    if constexpr (MASKED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + cg + 8 * i;
        key_ok[i] = key >= N || kvm[(size_t)b * N + key];
      }
    }

    // S = Qs K^T over c ascending: s[r][i] for row r0 + r, key cg + 8i
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[r][i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        qv[cc] = *reinterpret_cast<const float4*>(sQ + (c + cc) * F32_BQ + r0);
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = *reinterpret_cast<const float4*>(sk + 8 * i * G::KLD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kc[4] = {kv[i].x, kv[i].y, kv[i].z, kv[i].w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          sc[0][i] = fmaf(qv[cc].x, kc[cc], sc[0][i]);
          sc[1][i] = fmaf(qv[cc].y, kc[cc], sc[1][i]);
          sc[2][i] = fmaf(qv[cc].z, kc[cc], sc[2][i]);
          sc[3][i] = fmaf(qv[cc].w, kc[cc], sc[3][i]);
        }
      }
    }

    // the tile's row max among the row's 8 owners, p = exp2f(s - m) into
    // this warp's slice, O and the factor for l rescaled
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (MASKED) {
          if (!key_ok[i]) sc[r][i] = -1e30f;  // masked key: -1e30 before the row max
        }
        if (k0 + cg + 8 * i >= N) sc[r][i] = -INFINITY;  // ragged kv edge: no weight
        mx = fmaxf(mx, sc[r][i]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key 0 lies in the first tile, so the max is finite from here on
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
#pragma unroll
      for (int j = 0; j < G::COLS; ++j) acc[r][j] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(myp + (cg + 8 * i) * 16 + 4 * rl) =
          make_float4(exp2f(sc[0][i] - m[0]), exp2f(sc[1][i] - m[1]), exp2f(sc[2][i] - m[2]),
                      exp2f(sc[3][i] - m[3]));
    __syncwarp();

    // O += P V and l += p, keys in order
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(myp + j * 16 + 4 * rl);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      float v[G::COLS];
#pragma unroll
      for (int g = 0; g < G::NV; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(sv + j * C + 32 * g + 4 * cg);
        v[4 * g] = x.x, v[4 * g + 1] = x.y, v[4 * g + 2] = x.z, v[4 * g + 3] = x.w;
      }
      if constexpr (G::NT > 0) {
        const float2 x = *reinterpret_cast<const float2*>(sv + j * C + 32 * G::NV + 2 * cg);
        v[4 * G::NV] = x.x, v[4 * G::NV + 1] = x.y;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        l[r] = j == 0 ? fmaf(l[r], alpha[r], p[r]) : l[r] + p[r];
#pragma unroll
        for (int c = 0; c < G::COLS; ++c) acc[r][c] = fmaf(p[r], v[c], acc[r][c]);
      }
    }  // the next tile's barrier orders these reads before its p writes
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + r0 + r;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    float* orow = o + ((size_t)b * N + row) * HC + h * C;
#pragma unroll
    for (int g = 0; g < G::NV; ++g)
      *reinterpret_cast<float4*>(orow + 32 * g + 4 * cg) =
          make_float4(acc[r][4 * g] * inv, acc[r][4 * g + 1] * inv, acc[r][4 * g + 2] * inv,
                      acc[r][4 * g + 3] * inv);
    if constexpr (G::NT > 0)
      *reinterpret_cast<float2*>(orow + 32 * G::NV + 2 * cg) =
          make_float2(acc[r][4 * G::NV] * inv, acc[r][4 * G::NV + 1] * inv);
    if (cg == 0) lse[((size_t)b * H + h) * N + row] = m[r] + log2f(l[r]);
  }
}

// kvm == nullptr launches the unmasked instance
template <int C>
int launch_f32(const void* qkv, const void* kvm, void* o, void* lse, int B, int N, int H,
               float qscale, void* stream) {
  const dim3 grid((N + F32_BQ - 1) / F32_BQ, H, B);
  return jt::launch(kvm ? flash_fwd_f32_kernel<C, true> : flash_fwd_f32_kernel<C, false>, grid,
                    F32_THREADS, F32Geo<C>::SMEM, stream, (const float*)qkv,
                    (const uint8_t*)kvm, (float*)o, (float*)lse, N, H, qscale);
}

}  // namespace

#define JT_FWD_ENTRY(C)                                                         \
  extern "C" int jt_flash_fwd_c##C(const void* qkv, const void* kvm, void* o,   \
                                   void* lse, int B, int N, int H,              \
                                   float qscale, void* stream) {                \
    return launch<C>(qkv, kvm, o, lse, B, N, H, qscale, stream);                \
  }

JT_FWD_ENTRY(32)
JT_FWD_ENTRY(64)
JT_FWD_ENTRY(80)
JT_FWD_ENTRY(96)
JT_FWD_ENTRY(128)

#define JT_FWD_F32_ENTRY(C)                                                     \
  extern "C" int jt_flash_fwd_f32_c##C(const void* qkv, const void* kvm,        \
                                       void* o, void* lse, int B, int N, int H, \
                                       float qscale, void* stream) {            \
    return launch_f32<C>(qkv, kvm, o, lse, B, N, H, qscale, stream);            \
  }

JT_FWD_F32_ENTRY(32)
JT_FWD_F32_ENTRY(64)
JT_FWD_F32_ENTRY(80)
JT_FWD_F32_ENTRY(96)
JT_FWD_F32_ENTRY(128)
