// H1: flash self-attention forward over the fused qkv projection, bf16
// (and, at the end of this file, the entries of H1-fp32 for fp32 qkv,
// csrc/flash_f32.cuh's FFMA forward).
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
#include "flash_f32.cuh"

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

// H1-fp32: the same forward for fp32 qkv (the frozen evals with
// optimization.use_bfloat16: false, and pretraining with meta.dtype:
// float32), the fp32 instance of _fwd_tm_kernel: csrc/flash_f32.cuh's FFMA
// forward over the column ranges of qkv. Head dims 64, 80, 96 and 128 serve
// the fp32 evals' encoders; 32 (the predictors' 24 zero-padded), 64 and
// 128 (vit_tiny's 384-wide predictor) also fp32 pretraining, whose backward
// is H2-fp32 (csrc/flash_attention_bwd_f32.cu).
#define JT_FWD_F32_ENTRY(C)                                                     \
  extern "C" int jt_flash_fwd_f32_c##C(const void* qkv, const void* kvm,        \
                                       void* o, void* lse, int B, int N, int H, \
                                       float qscale, void* stream) {            \
    HmArgs a;                                                                   \
    if (!jtf32::tm_args(a, qkv, kvm, nullptr, o, lse, nullptr, nullptr, B, N,   \
                        H, C, qscale, 0.f))                                     \
      return (int)cudaErrorInvalidValue;                                        \
    return jtf32::launch_fwd<C>(a, stream);                                     \
  }

JT_FWD_F32_ENTRY(32)
JT_FWD_F32_ENTRY(64)
JT_FWD_F32_ENTRY(80)
JT_FWD_F32_ENTRY(96)
JT_FWD_F32_ENTRY(128)
