// The fp32 flash attention kernels: a forward, a dq kernel and a dk/dv
// kernel (optionally with dq partials), register-tiled FFMA on the CUDA
// cores, over operands addressed by (batch, head, row) element strides
// (HmArgs, csrc/flash_hm.cuh). Two sets of entries launch them:
//
//   H1-fp32 / H2-fp32, the token-major fp32 instances (csrc/flash_attention.cu,
//   csrc/flash_attention_bwd_f32.cu): q, k, v are column ranges of the fused
//   projection qkv [B, N, 3*H*C], o and do are [B, N, H*C], dq, dk, dv the
//   column ranges of dqkv (tm_args). They replace the fp32 instances of
//   jepa_tpu/ops/flash_attention.py's _fwd_tm_kernel (K1), _dq_tm_kernel
//   (K4) and _dkv_tm_kernel (K5), which together compute what the merged
//   _bwd_tm_kernel (K3) does.
//
//   H4-H7-fp32, the head-major fp32 instances (csrc/flash_attention_hm_f32.cu):
//   q [B, H, Nq, C], k, v [B, H, Nk, C] and the outputs by their own
//   strides, so the planes of a packed [3, B, H, N, C] qkv or a permuted
//   view of the token-major projection are used in place. They replace the
//   fp32 instances of _fwd_kernel (K6), _dq_kernel (K7), _dkv_kernel (K8)
//   and _dqkv_kernel (K9).
//
// The TPU kernels are dtype-generic, and every rounding point of their bf16
// instances (q * (scale*log2e), p as the PV and dV operand, ds before dK
// and dQ) is a no-op in fp32. Forward: base-2 online softmax, o = acc /
// max(l, 1e-30), lse = m + log2(max(l, 1e-30)) (K6's clamp; l >= 1 whenever
// a row has a key, so K1's o = acc / l is the same number). Backward: p =
// exp2(s - lse), ds = p * (dp - delta), dk scaled by 1/log2e and dq by
// `scale`; delta = sum_c do*o in plain torch.
//
// Key mask (the padded mask mode), a template flag: a masked key scores
// -1e30 before the row max (forward) and before exp2(s - lse) (backward),
// so its p and ds are 0 and its dk and dv exactly 0; a row with no valid
// key gets the uniform average. Edges: rows past Nq or Nk are zero-filled
// on load and guarded (a zero row scores s = 0, which is no zero weight,
// and 0 * NaN is NaN): keys past Nk get no weight in the forward and p =
// ds = 0 in the backward, q rows past Nq p = ds = 0 in the dk/dv kernel.
//
// What bounds it on the H100: fp32 has no dense tensor-core path (TF32 is
// not fp32), so the products run on the CUDA cores (FFMA, 66.9 TFLOP/s):
// per (batch, head) the forward does 4*Nq*Nk*C flops, the dq kernel 6, the
// dk/dv kernel 8 and the dk/dv kernel with dq partials 10, against O((Nq +
// Nk)*C) bytes, so every kernel is FFMA-bound at the training shapes. Each
// FFMA's two operands come from registers, the registers from shared
// memory: a thread's register tile sets the shared-memory loads per FFMA,
// and the warps an SM holds (registers and shared memory a block) set how
// much of the loads' latency and of each block barrier is hidden.
//
// Design (register-tiled, as a SIMT GEMM): a block owns BR rows of one
// (batch, head): q rows in the forward and the dq kernel, keys in the dk/dv
// kernel. Thread (rg, cg) of warp w (rg = 4w + lane%4, cg = lane/4) owns the
// block's rows R*rg..R*rg+R-1 and, per BT-row tile of the streamed
// operand, its rows cg + 8i (i < BT/8) and the head columns 32g + 4cg.. (g <
// C/32; at C=16 and 80, 32*(C/32)+2cg.. too) of its outputs, so a row's 8
// owners sit in one warp. The block's own operands (scaled Qs in the
// forward and the dq kernel, K and V in the dk/dv kernel, dO) are stored
// c-major once ([C][BR]); the streamed tiles (BT rows, padded to C+4 floats
// so the 8 column groups fall in 8 bank groups) run through a cp.async
// ring, one __syncthreads a tile. Per 4 head columns a thread loads R
// float4 of the block's operand and BT/8 of the tile for 4*R*BT/8 FFMAs. p
// (and ds) go to the warp's own [BT][4R] slice of shared memory (a
// __syncwarp, no block barrier), and the products with the tile's rows
// read them back a float4 of 4 rows at a time against a float4 of the
// tile's columns.
//
//   forward (H1-fp32, H4-fp32): BR=128, R=4, 32-key tiles, 2 stages; S = Qs
//   K^T; the row max over the tile by shuffles among the row's 8 owners; p
//   = exp2(s - m); O += P V and l += p in key order. Head dims 16, 32, 64
//   and 80 ask for two blocks an SM (128 registers a thread); at 96 and 128
//   the accumulators (48 and 64 a thread) and the shared memory (113 and
//   145 KB a block) leave room for one.
//
//   dq kernel (H2-fp32, H5-fp32): S = Qs K^T and dP = dO V^T in one loop over
//   c, p = exp2f(s - lse), ds = p*(dp - delta), dQ += ds K over the keys
//   ascending; dq = dQ * scale at the end.
//
//   dk/dv kernel (H2-fp32, H6-fp32): K and V of the block; Q and dO tiles
//   stream, each thread reads the lse and delta of its tile rows from
//   global memory (cached; used after the scores). Each thread scales the
//   Q elements it copied itself (q * qscale, one IEEE multiply, as the dq
//   kernel's block operand), after its cp.async wait and before the tile's
//   one block barrier. p goes to the warp's exchange slice for dV += p dO,
//   then ds takes its place for dK += ds Qs, q rows ascending; dk = dK *
//   (1/log2e) at the end.
//
//   Split kernels (BwdGeo SPLIT): two warp sets over the same rows, one for
//   each score product. Warp pw of set 0 forms s and p and hands p to warp
//   PAIRS + pw through their slice (a named barrier each way, no block
//   barrier), which forms dp and ds. dk/dv: set 0 sums dV += p dO and set 1
//   dK += ds Qs, so a thread holds one output's accumulators, not both.
//   dq: ds goes back to set 0 and each set sums half of a row's columns.
//   Half the registers buy more warps or larger tiles: at C=80, 96 and 128
//   the dk/dv kernel runs two blocks of 8 warps an SM where it ran two of 4
//   (128 registers), at C=64 8 rows x 8 tile rows a thread (one block of 8
//   warps an SM); at C=128 the dq kernel runs two blocks of 8 warps.
//
//   Masked keys: a tile of keys that are all masked (or past Nk) is skipped
//   by the dq kernels, and a block of them stores dk = dv = 0 and returns
//   (keys_masked). The padded mode's key mask is runs of pads: the
//   predictor's context pads, then a ragged tail.
//
//   Geometry (DqPick / DkvPick, measured on an H100 80GB HBM3 at 700 W):
//   blocks of 64 rows, 32-row tiles, one stage where a second block needs
//   the room. Every geometry measured ran at 50-56 % of the FFMA bound:
//   blocks of 128 threads (12 warps an SM at C=64) or the split's 256, 4 x 4
//   or 8 x 8 score tiles, 16- or 64-row tiles, 1-3 stages, a ring of
//   full / empty mbarriers in place of the tile's __syncthreads (no gain
//   at the same geometry), unrolls of 2-16. So the choice per head dim is
//   what measured fastest, not a model. The unsplit dq stays at C <= 96
//   (its split ran 4-10 % slower), the unsplit dk/dv at C <= 32.
//
//   dk/dv kernel with dq partials (kDQ, H7-fp32): K9 sums dq over its key
//   blocks in VMEM scratch because the TPU grid runs in order; Hopper's
//   blocks run in no order, and fp32 atomics would add in a different
//   order each run. So each block (one k-block of 128 keys: the partial's
//   width fixes dq's bits) also keeps K row-major ([128][C+4]); after a
//   tile's ds (a block barrier: every warp's ds), thread (rg, cg) sums
//   dQ_part = ds K for q row rg of the tile at its columns over the block's
//   128 keys ascending (a float4 of 4 keys' ds, a float4 of each key's
//   columns) and stores it in the k-block's own slab of the workspace ws
//   [ceil(Nk/128), B, H, Nq, C]. The finish pass (flash_hm_dq_finish_kernel)
//   sums the slabs in k-block order and scales: deterministic, no atomics.
//   It keeps BR=128 with R=4 (256 threads: a row group a tile row), p and
//   ds each in a slice of its own (ds leaves the registers before the
//   sums), and the tiles' lse and delta staged a tile ahead in shared
//   memory (4-byte cp.async): at the two-blocks launch bound of c <= 32
//   they would cost registers the partial needs (masked c=16 ran 5.7 %
//   slower with them in registers).
//
// Numerics, kept to the bit through the move to strided operands and
// through the backward's geometry (chip_smoke.py --kernel-ab): s, dp = fmaf
// chains over c ascending from 0 with q*qscale rounded once; forward: the
// max moves every 32 keys, alpha = exp2f(m - mx), l = fmaf(l, alpha, p of
// the tile's first key) then += p in key order, acc = acc*alpha then
// fmaf(p, v, acc) in key order, o = acc * (1/l); backward: p = exp2f(s - lse), ds = p * (dp -
// delta), dq and dk/dv each one fmaf chain in key (q row) order, scaled
// once after the sums; H7-fp32's dq = scale * (((P0 + P1) + P2) + ...),
// each P_j one fmaf chain over its 128 keys.
#pragma once

#include <climits>
#include <initializer_list>
#include <type_traits>

#include "flash_hm.cuh"

namespace jtf32 {
namespace {

constexpr float INV_LOG2E = 0.69314718055994531f;  // 1/log2(e)

// ---- forward --------------------------------------------------------------

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
  static constexpr int NV = C / 32;              // float4 column groups of O (0-4)
  static constexpr int NT = (C % 32) / 8;        // float2 tail columns of O (0; 2 at C=16, 80)
  static constexpr int COLS = 4 * NV + NT;       // O columns a thread owns
  static constexpr int MINB = C <= 80 ? 2 : 1;   // blocks an SM, for the launch bound
};

// the K and V rows of keys [k0, k0 + 32) into one ring stage (rows past Nk
// zero-filled); kr, vr the head's rows, ks, vs their row strides
template <int C>
__device__ __forceinline__ void f32_load_kv(float* sk, float* sv, const float* kr, int ks,
                                            const float* vr, int vs, int k0, int Nk, int tid) {
  using G = F32Geo<C>;
  for (int i = tid; i < F32_BKV * C / 4; i += F32_THREADS) {
    const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
    const bool ok = k0 + r < Nk;
    const size_t row = ok ? k0 + r : 0;
    jt::cp_async16(sk + r * G::KLD + c4, kr + row * ks + c4, ok);
    jt::cp_async16(sv + r * C + c4, vr + row * vs + c4, ok);
  }
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(F32_THREADS, F32Geo<C>::MINB)
flash_fwd_f32_kernel(const HmArgs a) {
  using G = F32Geo<C>;
  float* sQ = reinterpret_cast<float*>(jt::smem_bytes());
  float* sK = sQ + G::SQ;                  // stage s at s * SK
  float* sV = sK + F32_STAGES * G::SK;     // stage s at s * SV
  float* sP = sV + F32_STAGES * G::SV;

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * F32_BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = 4 * (4 * warp + rl);  // block row of row 0
  const int Nq = a.Nq, Nk = a.Nk;
  const float* qr = hm_rows<const float>(a.q, a.q_s, b, h);
  const float* kr = hm_rows<const float>(a.k, a.k_s, b, h);
  const float* vr = hm_rows<const float>(a.v, a.v_s, b, h);
  const int ks = a.k_s[2], vs = a.v_s[2];
  const uint8_t* kvm = static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk;
  const int nkv = (Nk + F32_BKV - 1) / F32_BKV;

  f32_load_kv<C>(sK, sV, kr, ks, vr, vs, 0, Nk, tid);
  jt::cp_async_commit();
  // Qs c-major: column c of the tile's rows at sQ + c * 128
  for (int i = tid; i < F32_BQ * C / 4; i += F32_THREADS) {
    const int r = i % F32_BQ, c4 = 4 * (i / F32_BQ);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Nq) x = *reinterpret_cast<const float4*>(qr + (size_t)(q0 + r) * a.q_s[2] + c4);
    sQ[(c4 + 0) * F32_BQ + r] = x.x * a.qscale;
    sQ[(c4 + 1) * F32_BQ + r] = x.y * a.qscale;
    sQ[(c4 + 2) * F32_BQ + r] = x.z * a.qscale;
    sQ[(c4 + 3) * F32_BQ + r] = x.w * a.qscale;
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
      f32_load_kv<C>(sK + n * G::SK, sV + n * G::SV, kr, ks, vr, vs, k0 + F32_BKV, Nk, tid);
      jt::cp_async_commit();
    }
    const float* sk = sK + s * G::SK + cg * G::KLD;  // key cg; key cg + 8i at + 8i*KLD
    const float* sv = sV + s * G::SV;
    bool key_ok[4] = {true, true, true, true};  // MASKED: key cg + 8i valid or past Nk
    if constexpr (MASKED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + cg + 8 * i;
        key_ok[i] = key >= Nk || kvm[key];
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
        if (k0 + cg + 8 * i >= Nk) sc[r][i] = -INFINITY;  // ragged kv edge: no weight
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

  float* orows = hm_rows<float>(a.o, a.o_s, b, h);
  float* lrow = static_cast<float*>(a.lse) + ((size_t)b * a.H + h) * Nq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Nq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    float* orow = orows + (size_t)row * a.o_s[2];
#pragma unroll
    for (int g = 0; g < G::NV; ++g)
      *reinterpret_cast<float4*>(orow + 32 * g + 4 * cg) =
          make_float4(acc[r][4 * g] * inv, acc[r][4 * g + 1] * inv, acc[r][4 * g + 2] * inv,
                      acc[r][4 * g + 3] * inv);
    if constexpr (G::NT > 0)
      *reinterpret_cast<float2*>(orow + 32 * G::NV + 2 * cg) =
          make_float2(acc[r][4 * G::NV] * inv, acc[r][4 * G::NV + 1] * inv);
    if (cg == 0) lrow[row] = m[r] + log2f(lc);
  }
}

// ---- backward ---------------------------------------------------------------

// The columns a thread owns of a block row: 32g + 4cg.. (G0 <= g < G1) and,
// with TAIL (at C=16 and 80), the float2 tail 32*(C/32) + 2cg..; the full
// set's 8 column groups cover [0, C), a split kernel's two warp sets take a
// range each
template <int C, int G0 = 0, int G1 = C / 32, bool TAIL = (C % 32 != 0)>
struct Cols {
  static constexpr int V0 = G0;            // first float4 group
  static constexpr int NV = G1 - G0;       // float4 column groups (0-4)
  static constexpr int NT = TAIL ? 2 : 0;  // float2 tail columns
  static constexpr int COLS = 4 * NV + NT;
  static constexpr int TAIL_AT = 32 * (C / 32);
  static_assert(C % 16 == 0 && G0 >= 0 && G1 <= C / 32 && (!TAIL || C % 32 != 0) && COLS > 0,
                "Cols: whole float4 groups of the head dim and its float2 tail");
};
static_assert(8 * Cols<16>::COLS == 16 && 8 * Cols<80>::COLS == 80 && 8 * Cols<128>::COLS == 128,
              "Cols: the full set's columns cover the head dim exactly");

// the two halves of a row's columns (a split dq kernel's warp sets)
template <int C>
using ColsA = Cols<C, 0, (C / 32 + 1) / 2, false>;
template <int C>
using ColsB = Cols<C, (C / 32 + 1) / 2, C / 32, (C % 32 != 0)>;

// The backward's geometry: a block owns BR rows (q rows in the dq kernel,
// keys in the dk/dv kernel) with BR/R row groups x 8 column groups of
// threads, R rows x C/8 columns a thread; the other operand streams in
// BT-row tiles through a STAGES-deep cp.async ring; MINB blocks an SM for
// the launch bound. SPLIT: two warp sets over the same rows, one for each
// score product (s = Qs K^T, dp = dO V^T), p handed from the first to the
// second through shared memory (the split kernels).
template <int C, int BR_, int BT_, int STAGES_, int MINB_, int R_ = 4, int US_ = 4, int UA_ = 4,
          bool SPLIT_ = false>
struct BwdGeo : Cols<C> {
  static constexpr int BR = BR_, BT = BT_, STAGES = STAGES_, MINB = MINB_, R = R_;
  static constexpr int US = US_, UA = UA_;  // unrolled c steps of the scores, tile rows of the sums
  static constexpr bool SPLIT = SPLIT_;
  static constexpr int SET = BR / R * 8;         // threads of one warp set
  static constexpr int THREADS = SPLIT ? 2 * SET : SET;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int PAIRS = SET / 32;         // warps a set (a warp and its partner)
  static constexpr int NI = BT / 8;              // tile rows a thread scores: cg + 8i
  static constexpr int LD = C + 4;               // padded row of a streamed tile, floats
  static constexpr int SR = C * BR;              // a block operand, c-major [C][BR]
  static constexpr int ST = BT * LD;             // a streamed tile [BT][C+4]
  static constexpr int XW = R == 4 ? 16 : 36;    // a row of the exchange: a warp's 4R rows (+ pad)
  static constexpr int SW = PAIRS * BT * XW;     // one exchange, a slice [BT][XW] a warp (pair)
  static_assert((R == 4 || R == 8) && BR % (4 * R) == 0 && SET % 32 == 0 && BT % 8 == 0 &&
                    STAGES >= 1 && C % (4 * US) == 0 && BT % UA == 0 &&
                    (!SPLIT || 2 * PAIRS < 16),
                "BwdGeo: R, BR, BT, STAGES, US, UA, and the split's named barriers");
  // dq: Qs, dO; K and V tiles; ds (split: p, then ds in its place). dk/dv:
  // K, V; Qs and dO tiles; p, then ds (split: p and ds, a slice each)
  static constexpr int DQ_SMEM = 4 * (2 * SR + 2 * STAGES * ST + SW);
  static constexpr int SMEM = 4 * (2 * SR + 2 * STAGES * ST + (SPLIT ? 2 : 1) * SW);
  // with dq partials: also a ds exchange of its own, the tiles' lse and
  // delta, and K row-major [BR][C+4]
  static constexpr int DQKV_SMEM = SMEM + 4 * (SW + 2 * STAGES * BT + BR * LD);
};

// The geometries the launches use, per head dim (BR, BT, STAGES, MINB, R,
// US, UA, SPLIT; the fastest measured on the H100, see the header). The dq
// and dk/dv kernels' bits do not depend on the geometry.
template <int C> struct DqPick;
template <> struct DqPick<16> { using G = BwdGeo<16, 128, 32, 2, 3, 8, 4, 8>; };
template <> struct DqPick<32> { using G = BwdGeo<32, 64, 32, 2, 4, 4, 4, 32>; };
template <> struct DqPick<64> { using G = BwdGeo<64, 64, 32, 2, 3, 4, 8, 8>; };
template <> struct DqPick<80> { using G = BwdGeo<80, 64, 32, 1, 2, 4, 5, 8>; };
template <> struct DqPick<96> { using G = BwdGeo<96, 64, 32, 2, 2, 4, 8, 8>; };
template <> struct DqPick<128> { using G = BwdGeo<128, 64, 32, 1, 2, 4, 8, 8, true>; };
template <int C> struct DkvPick;
template <> struct DkvPick<16> { using G = BwdGeo<16, 128, 32, 2, 3, 8, 2, 8>; };
template <> struct DkvPick<32> { using G = BwdGeo<32, 64, 32, 2, 4, 4, 8, 16>; };
template <> struct DkvPick<64> { using G = BwdGeo<64, 128, 64, 2, 1, 8, 2, 8, true>; };
template <> struct DkvPick<80> { using G = BwdGeo<80, 64, 32, 1, 2, 4, 5, 8, true>; };
template <> struct DkvPick<96> { using G = BwdGeo<96, 64, 32, 1, 2, 4, 4, 8, true>; };
template <> struct DkvPick<128> { using G = BwdGeo<128, 64, 32, 1, 2, 4, 4, 8, true>; };
// H7-fp32: 128 keys a block, the width of its dq partial (which fixes dq's
// bits), R = 4 so that each row group owns one q row of a tile's partial
template <int C>
using DqkvGeo = BwdGeo<C, 128, 32, 2, (C <= 32 ? 2 : 1), 4, (C == 16 ? 2 : 8), (C == 16 ? 4 : 8)>;
template <int C>
using DqGeo = typename DqPick<C>::G;
template <int C>
using DkvGeo = typename DkvPick<C>::G;

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes global -> shared (cp.async.ca: the 4-byte form), zero-filled
// when `valid` is false (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + BT) of a head's rows (row stride rs floats) into a padded
// tile, rows past n zero-filled
template <class G, int C>
__device__ __forceinline__ void load_tile(float* dst, const float* rows, int rs, int r0, int n,
                                          int tid) {
  for (int i = tid; i < G::BT * C / 4; i += G::THREADS) {
    const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
    const bool ok = r0 + r < n;
    jt::cp_async16(dst + r * G::LD + c4, rows + (size_t)(ok ? r0 + r : 0) * rs + c4, ok);
  }
}

// No key of [k0, k0 + N) is both below Nk and valid (a ballot over the
// keys, the same in every warp, so a block skips them as one). Their p and
// ds are 0, and a chain of fmaf(0, x, acc) terms from +0 never leaves +0 or
// moves a nonzero acc, so skipping them keeps every output's bits.
template <int N>
__device__ __forceinline__ bool keys_masked(const uint8_t* kvm, int k0, int Nk, int lane) {
  bool valid = false;
#pragma unroll
  for (int j = lane; j < N; j += 32) valid = valid || (k0 + j < Nk && kvm[k0 + j]);
  return !__any_sync(0xffffffffu, valid);
}

// the float4s this thread copied into a tile (load_tile's own indices),
// times `mul`, in place: after its cp.async wait, before the block barrier
template <class G, int C>
__device__ __forceinline__ void scale_own(float* dst, float mul, int tid) {
  for (int i = tid; i < G::BT * C / 4; i += G::THREADS) {
    float4* p = reinterpret_cast<float4*>(dst + (i / (C / 4)) * G::LD + 4 * (i % (C / 4)));
    float4 x = *p;
    x.x *= mul, x.y *= mul, x.z *= mul, x.w *= mul;
    *p = x;
  }
}

// the block's rows [r0, r0 + BR) of a head's rows (row stride rs floats),
// times `mul`, stored c-major (column c at dst + c*BR); rows past n are zero
template <class G, int C>
__device__ __forceinline__ void load_block(float* dst, const float* rows, int rs, int r0, int n,
                                           float mul, int tid) {
  for (int i = tid; i < G::BR * C / 4; i += G::THREADS) {
    const int r = i % G::BR, c4 = 4 * (i / G::BR);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(rows + (size_t)(r0 + r) * rs + c4);
    dst[(c4 + 0) * G::BR + r] = x.x * mul;
    dst[(c4 + 1) * G::BR + r] = x.y * mul;
    dst[(c4 + 2) * G::BR + r] = x.z * mul;
    dst[(c4 + 3) * G::BR + r] = x.w * mul;
  }
}

// a[r][i] = sum_c A[c][r0 + r] * X[cg + 8i][c] and b[r][i] = sum_c
// Bm[c][r0 + r] * Y[cg + 8i][c] (r < R), each an fmaf chain over c ascending
// from 0: A, Bm the block's c-major operands, x, y the tile rows of key / q
// row cg (row cg + 8i at + 8i*LD)
template <class G, int C>
__device__ __forceinline__ void score_pair(float (&a)[G::R][G::NI], float (&bb)[G::R][G::NI],
                                           const float* A, const float* Bm, const float* x,
                                           const float* y, int r0) {
  constexpr int LD = G::LD, NI = G::NI, R4 = G::R / 4;
#pragma unroll
  for (int r = 0; r < G::R; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) a[r][i] = bb[r][i] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += 4 * G::US)
#pragma unroll
  for (int u = 0; u < G::US; ++u) {
    const int c = c0 + 4 * u;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float* M = pass ? Bm : A;
      const float* t = pass ? y : x;
      float(&acc)[G::R][NI] = pass ? bb : a;
      float4 av[4][R4], xv[NI];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int k = 0; k < R4; ++k)
          av[cc][k] = *reinterpret_cast<const float4*>(M + (c + cc) * G::BR + r0 + 4 * k);
#pragma unroll
      for (int i = 0; i < NI; ++i) xv[i] = *reinterpret_cast<const float4*>(t + 8 * i * LD + c);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float xc[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int k = 0; k < R4; ++k) {
            acc[4 * k + 0][i] = fmaf(av[cc][k].x, xc[cc], acc[4 * k + 0][i]);
            acc[4 * k + 1][i] = fmaf(av[cc][k].y, xc[cc], acc[4 * k + 1][i]);
            acc[4 * k + 2][i] = fmaf(av[cc][k].z, xc[cc], acc[4 * k + 2][i]);
            acc[4 * k + 3][i] = fmaf(av[cc][k].w, xc[cc], acc[4 * k + 3][i]);
          }
      }
    }
  }
}

// a[r][i] = sum_c A[c][r0 + r] * X[cg + 8i][c] (r < R): score_pair's one
// product, an fmaf chain over c ascending from 0
template <class G, int C>
__device__ __forceinline__ void score_one(float (&a)[G::R][G::NI], const float* A, const float* x,
                                          int r0) {
  constexpr int LD = G::LD, NI = G::NI, R4 = G::R / 4;
#pragma unroll
  for (int r = 0; r < G::R; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) a[r][i] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += 4 * G::US)
#pragma unroll
  for (int u = 0; u < G::US; ++u) {
    const int c = c0 + 4 * u;
    float4 av[4][R4], xv[NI];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int k = 0; k < R4; ++k)
        av[cc][k] = *reinterpret_cast<const float4*>(A + (c + cc) * G::BR + r0 + 4 * k);
#pragma unroll
    for (int i = 0; i < NI; ++i) xv[i] = *reinterpret_cast<const float4*>(x + 8 * i * LD + c);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float xc[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int k = 0; k < R4; ++k) {
          a[4 * k + 0][i] = fmaf(av[cc][k].x, xc[cc], a[4 * k + 0][i]);
          a[4 * k + 1][i] = fmaf(av[cc][k].y, xc[cc], a[4 * k + 1][i]);
          a[4 * k + 2][i] = fmaf(av[cc][k].z, xc[cc], a[4 * k + 2][i]);
          a[4 * k + 3][i] = fmaf(av[cc][k].w, xc[cc], a[4 * k + 3][i]);
        }
    }
  }
}

// a named barrier's arrival without the wait (the producer's half of
// bar_sync(id, count))
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the thread's columns (a Cols set CS) of a tile row
template <class CS>
__device__ __forceinline__ void tile_cols(float (&v)[CS::COLS], const float* row, int cg) {
  constexpr int NV = CS::NV;
#pragma unroll
  for (int g = 0; g < NV; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(row + 32 * (CS::V0 + g) + 4 * cg);
    v[4 * g] = x.x, v[4 * g + 1] = x.y, v[4 * g + 2] = x.z, v[4 * g + 3] = x.w;
  }
  if constexpr (CS::NT > 0) {
    const float2 x = *reinterpret_cast<const float2*>(row + CS::TAIL_AT + 2 * cg);
    v[4 * NV] = x.x, v[4 * NV + 1] = x.y;
  }
}

// v[...] * mul into a row's columns (a Cols set CS)
template <class CS>
__device__ __forceinline__ void put_cols(float* o, const float* v, float mul, int cg) {
  constexpr int NV = CS::NV;
#pragma unroll
  for (int g = 0; g < NV; ++g)
    *reinterpret_cast<float4*>(o + 32 * (CS::V0 + g) + 4 * cg) =
        make_float4(v[4 * g] * mul, v[4 * g + 1] * mul, v[4 * g + 2] * mul, v[4 * g + 3] * mul);
  if constexpr (CS::NT > 0)
    *reinterpret_cast<float2*>(o + CS::TAIL_AT + 2 * cg) =
        make_float2(v[4 * NV] * mul, v[4 * NV + 1] * mul);
}

// acc[r][...] * mul into the row's columns (put_cols) of a head's rows
// (row stride rs; rows past n dropped)
template <class CS, int R>
__device__ __forceinline__ void store_rows(float* rows, int rs, const float (&acc)[R][CS::COLS],
                                           float mul, int row0, int n, int cg) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (row0 + r < n) put_cols<CS>(rows + (size_t)(row0 + r) * rs, acc[r], mul, cg);
}

// w[r][i] (the thread's R rows at tile row cg + 8i) into the warp's exchange
// slice [BT][XW]: row group rl's R values of tile row j at j*XW + R*rl
template <class G>
__device__ __forceinline__ void put_exchange(float* w, const float (&v)[G::R][G::NI], int rl,
                                             int cg) {
#pragma unroll
  for (int i = 0; i < G::NI; ++i)
#pragma unroll
    for (int k = 0; k < G::R / 4; ++k)
      *reinterpret_cast<float4*>(w + (cg + 8 * i) * G::XW + G::R * rl + 4 * k) =
          make_float4(v[4 * k][i], v[4 * k + 1][i], v[4 * k + 2][i], v[4 * k + 3][i]);
}

// acc[r][c] += w[j][r] * the thread's columns (CS) of tile row j, rows j in
// order: w the warp's exchange slice (put_exchange)
template <class G, class CS>
__device__ __forceinline__ void accumulate(float (&acc)[G::R][CS::COLS], const float* w,
                                           const float* tile, int rl, int cg) {
  constexpr int R = G::R;
#pragma unroll 1
  for (int j0 = 0; j0 < G::BT; j0 += G::UA)
#pragma unroll
  for (int u = 0; u < G::UA; ++u) {
    const int j = j0 + u;
    float d[R];
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + j * G::XW + R * rl + 4 * k);
      d[4 * k] = w4.x, d[4 * k + 1] = w4.y, d[4 * k + 2] = w4.z, d[4 * k + 3] = w4.w;
    }
    float x[CS::COLS];
    tile_cols<CS>(x, tile + j * G::LD, cg);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CS::COLS; ++c) acc[r][c] = fmaf(d[r], x[c], acc[r][c]);
  }
}

template <class G, int C, bool MASKED>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
flash_bwd_dq_f32_kernel(const HmArgs a) {
  constexpr int BT = G::BT, S = G::STAGES, NI = G::NI, R = G::R, COLS = Cols<C>::COLS;
  float* sQ = reinterpret_cast<float*>(jt::smem_bytes());
  float* sD = sQ + G::SR;
  float* sK = sD + G::SR;         // stage s at s * ST
  float* sV = sK + S * G::ST;     // stage s at s * ST
  float* sS = sV + S * G::ST;     // ds, per warp

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * G::BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = R * (4 * warp + rl);
  const int Nq = a.Nq, Nk = a.Nk;
  const float* kr = hm_rows<const float>(a.k, a.k_s, b, h);
  const float* vr = hm_rows<const float>(a.v, a.v_s, b, h);
  const int ks = a.k_s[2], vs = a.v_s[2];
  const uint8_t* kvm = static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk;
  const int nkv = (Nk + BT - 1) / BT;

  auto load_kv = [&](int t) {  // K and V of tile t into stage t % S: one group, empty past the end
    if (t < nkv) {
      load_tile<G, C>(sK + (t % S) * G::ST, kr, ks, t * BT, Nk, tid);
      load_tile<G, C>(sV + (t % S) * G::ST, vr, vs, t * BT, Nk, tid);
    }
    jt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < (S > 1 ? S - 1 : 1); ++t) load_kv(t);
  load_block<G, C>(sQ, hm_rows<const float>(a.q, a.q_s, b, h), a.q_s[2], q0, Nq, a.qscale, tid);
  load_block<G, C>(sD, hm_rows<const float>(a.dO, a.do_s, b, h), a.do_s[2], q0, Nq, 1.f, tid);
  float lr[R], dr[R];  // lse and delta of the thread's rows (0 past Nq)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + r0 + r;
    const size_t at = ((size_t)b * a.H + h) * Nq + row;
    lr[r] = row < Nq ? static_cast<const float*>(a.lse)[at] : 0.f;
    dr[r] = row < Nq ? static_cast<const float*>(a.delta)[at] : 0.f;
  }

  float acc[R][COLS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;
  float* myds = sS + warp * BT * G::XW;  // this warp's ds: [key][XW]

  for (int it = 0; it < nkv; ++it) {
    const int s = it % S, k0 = it * BT;
    bool key_ok[NI];  // key cg + 8i of the tile: below Nk (and valid, MASKED)
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int key = k0 + cg + 8 * i;
      key_ok[i] = key < Nk;
      if constexpr (MASKED) key_ok[i] = key_ok[i] && kvm[key];
    }
    cp_async_wait_group<(S > 1 ? S - 2 : 0)>();
    __syncthreads();  // tile it (and Qs, dO) in; every thread is done with tile it - 1
    if constexpr (S > 1) load_kv(it + S - 1);
    bool skip = false;  // a tile of masked keys: ds = 0
    if constexpr (MASKED) skip = keys_masked<BT>(kvm, k0, Nk, lane);
    const float* sk = sK + s * G::ST;
    if (!skip) {
      float sc[R][NI], dp[R][NI];
      score_pair<G, C>(sc, dp, sQ, sD, sk + cg * G::LD, sV + s * G::ST + cg * G::LD, r0);

      // ds = p (dp - delta), p = exp2(s - lse), in sc; keys past Nk and masked
      // keys get ds = 0
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float p = 0.f;
          if (k0 + cg + 8 * i < Nk) p = exp2f((key_ok[i] ? sc[r][i] : -1e30f) - lr[r]);
          sc[r][i] = p * (dp[r][i] - dr[r]);
        }
      put_exchange<G>(myds, sc, rl, cg);
      __syncwarp();
      accumulate<G, Cols<C>>(acc, myds, sk, rl, cg);  // dQ += ds K, keys in order
    }
    if constexpr (S == 1) {
      __syncthreads();  // every thread is done with the one stage
      load_kv(it + 1);
    }
  }  // the next tile's barrier orders these reads before its ds writes
  store_rows<Cols<C>, R>(hm_rows<float>(a.dq, a.dq_s, b, h), a.dq_s[2], acc, a.scale, q0 + r0,
                         Nq, cg);
}

// kDQ: also each tile's dq partial over the block's BR (128) keys, into the
// block's slab of ws [ceil(Nk/128), B, H, Nq, C]
template <class G, int C, bool MASKED, bool kDQ>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
flash_bwd_dkv_f32_kernel(const HmArgs a) {
  constexpr int BT = G::BT, S = G::STAGES, NI = G::NI, R = G::R, COLS = Cols<C>::COLS;
  static_assert(!kDQ || (R == 4 && 4 * G::WARPS == BT), "kDQ: a row group a tile row");
  float* sK = reinterpret_cast<float*>(jt::smem_bytes());
  float* sV = sK + G::SR;
  float* sQ = sV + G::SR;          // stage s at s * ST
  float* sD = sQ + S * G::ST;      // stage s at s * ST
  float* sX = sD + S * G::ST;      // p (and ds but with kDQ), per warp
  float* sY = kDQ ? sX + G::SW : sX;  // ds, per warp
  float* sL = sY + G::SW;          // kDQ: lse, stage s at s * BT
  float* sE = sL + S * BT;         // kDQ: delta, stage s at s * BT
  float* sKr = sE + S * BT;        // kDQ: K row-major [BR][C+4]

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * G::BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = R * (4 * warp + rl);
  const int Nq = a.Nq, Nk = a.Nk;
  const float* qr = hm_rows<const float>(a.q, a.q_s, b, h);
  const float* dor = hm_rows<const float>(a.dO, a.do_s, b, h);
  const float* kr = hm_rows<const float>(a.k, a.k_s, b, h);
  const int qs = a.q_s[2], dos = a.do_s[2], ks = a.k_s[2];
  const float* lrow = static_cast<const float*>(a.lse) + ((size_t)b * a.H + h) * Nq;
  const float* erow = static_cast<const float*>(a.delta) + ((size_t)b * a.H + h) * Nq;
  const int nq = (Nq + BT - 1) / BT;
  if constexpr (MASKED && !kDQ) {  // a block of masked keys: dk = dv = 0
    if (keys_masked<G::BR>(static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk, k0, Nk, lane)) {
      const float zero[R][COLS] = {};
      store_rows<Cols<C>, R>(hm_rows<float>(a.dk, a.dk_s, b, h), a.dk_s[2], zero, 1.f, k0 + r0,
                             Nk, cg);
      store_rows<Cols<C>, R>(hm_rows<float>(a.dv, a.dv_s, b, h), a.dv_s[2], zero, 1.f, k0 + r0,
                             Nk, cg);
      return;
    }
  }

  auto load_q = [&](int t) {  // Q and dO of tile t into stage t % S: one group, empty past the end
    if (t < nq) {
      load_tile<G, C>(sQ + (t % S) * G::ST, qr, qs, t * BT, Nq, tid);
      load_tile<G, C>(sD + (t % S) * G::ST, dor, dos, t * BT, Nq, tid);
      if (kDQ && tid < 2 * BT) {  // and the tile's lse and delta (zero past Nq)
        const int r = tid % BT, row = t * BT + r;
        cp_async4((tid < BT ? sL : sE) + (t % S) * BT + r,
                  (tid < BT ? lrow : erow) + (row < Nq ? row : 0), row < Nq);
      }
    }
    jt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < (S > 1 ? S - 1 : 1); ++t) load_q(t);
  load_block<G, C>(sK, kr, ks, k0, Nk, 1.f, tid);
  load_block<G, C>(sV, hm_rows<const float>(a.v, a.v_s, b, h), a.v_s[2], k0, Nk, 1.f, tid);
  if constexpr (kDQ) {
    for (int i = tid; i < G::BR * C / 4; i += G::THREADS) {
      const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Nk) x = *reinterpret_cast<const float4*>(kr + (size_t)(k0 + r) * ks + c4);
      *reinterpret_cast<float4*>(sKr + r * G::LD + c4) = x;
    }
  }
  bool key_ok[R];  // the thread's keys: below Nk (and valid, MASKED)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = k0 + r0 + r;
    key_ok[r] = key < Nk;
    if constexpr (MASKED)
      key_ok[r] = key_ok[r] && static_cast<const uint8_t*>(a.kvm)[(size_t)b * Nk + key];
  }

  float dk[R][COLS], dv[R][COLS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) dk[r][j] = dv[r][j] = 0.f;
  float* myp = sX + warp * BT * G::XW;  // this warp's p: [q row][XW]
  float* myds = sY + warp * BT * G::XW;  // its ds (in p's place but with kDQ)

  for (int it = 0; it < nq; ++it) {
    const int s = it % S, q0 = it * BT;
    // lse and delta of q row cg + 8i (0 past Nq): loaded here, so that the
    // scores hide the loads, or with dq partials staged a tile ahead (their
    // registers would spill under the launch bound)
    float l[NI], e[NI];
    if constexpr (!kDQ) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int row = q0 + cg + 8 * i;
        l[i] = row < Nq ? lrow[row] : 0.f;
        e[i] = row < Nq ? erow[row] : 0.f;
      }
    }
    float* sq = sQ + s * G::ST;
    cp_async_wait_group<(S > 1 ? S - 2 : 0)>();
    scale_own<G, C>(sq, a.qscale, tid);  // Qs = q * qscale, once, on this thread's own copies
    __syncthreads();  // tile it in and scaled; every thread is done with tile it - 1
    if constexpr (S > 1) load_q(it + S - 1);
    const float* sd = sD + s * G::ST;
    float sc[R][NI], dp[R][NI];
    score_pair<G, C>(sc, dp, sK, sV, sq + cg * G::LD, sd + cg * G::LD, r0);

    // p = exp2(s - lse) into dp, ds = p (dp - delta) into sc, for q row
    // cg + 8i; q rows past Nq, keys past Nk and masked keys get p = ds = 0
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if constexpr (kDQ) l[i] = sL[s * BT + cg + 8 * i], e[i] = sE[s * BT + cg + 8 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float p = 0.f;
        if (q0 + cg + 8 * i < Nq) p = exp2f((key_ok[r] ? sc[r][i] : -1e30f) - l[i]);
        sc[r][i] = p * (dp[r][i] - e[i]);
        dp[r][i] = p;
      }
    }
    put_exchange<G>(myp, dp, rl, cg);
    if constexpr (kDQ) {
      put_exchange<G>(myds, sc, rl, cg);
      __syncthreads();  // every warp's ds of tile it in
      // dQ_part[jq] = sum over the block's keys ascending of ds[jq][key] K[key],
      // for the tile's q row jq of this thread's row group
      const int jq = 4 * warp + rl;
      float dq[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) dq[c] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < G::BR; kk += 4) {  // keys kk..kk+3: warp kk/16's slots kk%16..
        const float4 d4 =
            *reinterpret_cast<const float4*>(sY + (kk / 16) * BT * G::XW + jq * G::XW + kk % 16);
        const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float k[COLS];
          tile_cols<Cols<C>>(k, sKr + (kk + u) * G::LD, cg);
#pragma unroll
          for (int c = 0; c < COLS; ++c) dq[c] = fmaf(d[u], k[c], dq[c]);
        }
      }
      if (q0 + jq < Nq) {
        put_cols<Cols<C>>(
            a.ws + ((((size_t)blockIdx.x * a.B + b) * a.H + h) * Nq + q0 + jq) * C, dq, 1.f, cg);
      }
    }
    __syncwarp();
    accumulate<G, Cols<C>>(dv, myp, sd, rl, cg);  // dV += p dO, q rows in order
    if constexpr (!kDQ) {
      __syncwarp();  // every lane's p read before ds takes its place
      put_exchange<G>(myds, sc, rl, cg);
      __syncwarp();
    }
    accumulate<G, Cols<C>>(dk, myds, sq, rl, cg);  // dK += ds Qs, q rows in order
    if constexpr (S == 1) {
      __syncthreads();  // every thread is done with the one stage
      load_q(it + 1);
    }
  }  // the next tile's barrier orders these reads before its p writes
  store_rows<Cols<C>, R>(hm_rows<float>(a.dk, a.dk_s, b, h), a.dk_s[2], dk, INV_LOG2E, k0 + r0, Nk,
                   cg);
  store_rows<Cols<C>, R>(hm_rows<float>(a.dv, a.dv_s, b, h), a.dv_s[2], dv, 1.f, k0 + r0, Nk, cg);
}

// ---- split kernels ------------------------------------------------------------
// Two warp sets over the block's rows: warp pw of set 0 and warp PAIRS + pw
// of set 1 own the same rows (a pair). Set 0 forms s and p = exp2(s - lse)
// and hands p to its partner through the pair's exchange slice (named
// barrier 1 + pw: set 0 arrives, set 1 waits); set 1 forms dp and ds = p (dp
// - delta). dq: ds takes p's place, handed back (barrier 1 + PAIRS + pw),
// and each set sums dQ += ds K at half of the row's columns (ColsA,
// ColsB). dk/dv: set 0 sums dV += p dO, set 1 dK += ds Qs from its own
// slice. Each output is the same fmaf chain as in the kernels above.

template <class G, int C, bool MASKED, int SET, class CS, class Load>
__device__ __forceinline__ void dq_split_set(const HmArgs& a, const float* sQ, const float* sD,
                                             const float* sK, const float* sV, float* x, int q0,
                                             int pw, int rl, int cg, int nkv, Load load_kv) {
  constexpr int BT = G::BT, S = G::STAGES, NI = G::NI, R = G::R;
  const int h = blockIdx.y, b = blockIdx.z, r0 = R * (4 * pw + rl);
  const int Nq = a.Nq, Nk = a.Nk, bar_p = 1 + pw, bar_ds = 1 + G::PAIRS + pw, lane = 4 * cg + rl;
  const uint8_t* kvm = static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk;
  const float* vec = static_cast<const float*>(SET ? a.delta : a.lse) + ((size_t)b * a.H + h) * Nq;
  float v[R];  // set 0: lse, set 1: delta of the thread's rows (0 past Nq)
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = q0 + r0 + r < Nq ? vec[q0 + r0 + r] : 0.f;
  float acc[R][CS::COLS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < CS::COLS; ++j) acc[r][j] = 0.f;

  for (int it = 0; it < nkv; ++it) {
    const int s = it % S, k0 = it * BT;
    cp_async_wait_group<(S > 1 ? S - 2 : 0)>();
    __syncthreads();  // tile it (and Qs, dO) in; every thread is done with tile it - 1
    if constexpr (S > 1) load_kv(it + S - 1);
    bool skip = false;  // a tile of masked keys: ds = 0
    if constexpr (MASKED) skip = keys_masked<BT>(kvm, k0, Nk, lane);
    const float* sk = sK + s * G::ST;
    if (!skip) {
      float sc[R][NI];
      if constexpr (SET == 0) {
        score_one<G, C>(sc, sQ, sk + cg * G::LD, r0);
        // p = exp2(s - lse); keys past Nk get p = 0, masked keys score -1e30
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int key = k0 + cg + 8 * i;
          bool ok = true;
          if constexpr (MASKED) ok = key >= Nk || kvm[key];
#pragma unroll
          for (int r = 0; r < R; ++r)
            sc[r][i] = key < Nk ? exp2f((ok ? sc[r][i] : -1e30f) - v[r]) : 0.f;
        }
        put_exchange<G>(x, sc, rl, cg);
        bar_arrive(bar_p, 64);
        jt::bar_sync(bar_ds, 64);  // the partner's ds in p's place
      } else {
        score_one<G, C>(sc, sD, sV + s * G::ST + cg * G::LD, r0);
        jt::bar_sync(bar_p, 64);  // the partner's p
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int k = 0; k < R / 4; ++k) {
            float4* w = reinterpret_cast<float4*>(x + (cg + 8 * i) * G::XW + R * rl + 4 * k);
            const float4 p = *w;
            *w = make_float4(
                p.x * (sc[4 * k][i] - v[4 * k]), p.y * (sc[4 * k + 1][i] - v[4 * k + 1]),
                p.z * (sc[4 * k + 2][i] - v[4 * k + 2]), p.w * (sc[4 * k + 3][i] - v[4 * k + 3]));
          }
        __syncwarp();
        bar_arrive(bar_ds, 64);
      }
      accumulate<G, CS>(acc, x, sk, rl, cg);  // dQ += ds K at CS's columns, keys in order
    }
    if constexpr (S == 1) {
      __syncthreads();  // every thread is done with the one stage
      load_kv(it + 1);
    }
  }  // the next tile's barrier orders these reads before its p writes
  store_rows<CS, R>(hm_rows<float>(a.dq, a.dq_s, b, h), a.dq_s[2], acc, a.scale, q0 + r0, Nq, cg);
}

template <class G, int C, bool MASKED>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
flash_bwd_dq_f32_split_kernel(const HmArgs a) {
  constexpr int BT = G::BT, S = G::STAGES;
  float* sQ = reinterpret_cast<float*>(jt::smem_bytes());
  float* sD = sQ + G::SR;
  float* sK = sD + G::SR;      // stage s at s * ST
  float* sV = sK + S * G::ST;  // stage s at s * ST
  float* sX = sV + S * G::ST;  // p, then ds, a slice a pair

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * G::BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pw = warp % G::PAIRS, rl = lane % 4, cg = lane / 4;
  const int Nq = a.Nq, Nk = a.Nk;
  const float* kr = hm_rows<const float>(a.k, a.k_s, b, h);
  const float* vr = hm_rows<const float>(a.v, a.v_s, b, h);
  const int ks = a.k_s[2], vs = a.v_s[2];
  const int nkv = (Nk + BT - 1) / BT;

  auto load_kv = [&](int t) {  // K and V of tile t into stage t % S: one group, empty past the end
    if (t < nkv) {
      load_tile<G, C>(sK + (t % S) * G::ST, kr, ks, t * BT, Nk, tid);
      load_tile<G, C>(sV + (t % S) * G::ST, vr, vs, t * BT, Nk, tid);
    }
    jt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < (S > 1 ? S - 1 : 1); ++t) load_kv(t);
  load_block<G, C>(sQ, hm_rows<const float>(a.q, a.q_s, b, h), a.q_s[2], q0, Nq, a.qscale, tid);
  load_block<G, C>(sD, hm_rows<const float>(a.dO, a.do_s, b, h), a.do_s[2], q0, Nq, 1.f, tid);
  float* x = sX + pw * BT * G::XW;
  if (warp < G::PAIRS)
    dq_split_set<G, C, MASKED, 0, ColsA<C>>(a, sQ, sD, sK, sV, x, q0, pw, rl, cg, nkv, load_kv);
  else
    dq_split_set<G, C, MASKED, 1, ColsB<C>>(a, sQ, sD, sK, sV, x, q0, pw, rl, cg, nkv, load_kv);
}

template <class G, int C, bool MASKED, int SET, class Load>
__device__ __forceinline__ void dkv_split_set(const HmArgs& a, const float* sK, const float* sV,
                                              float* sQ, const float* sD, float* x, float* y,
                                              int k0, int pw, int rl, int cg, int tid, int nq,
                                              Load load_q) {
  constexpr int BT = G::BT, S = G::STAGES, NI = G::NI, R = G::R, COLS = Cols<C>::COLS;
  const int h = blockIdx.y, b = blockIdx.z, r0 = R * (4 * pw + rl);
  const int Nq = a.Nq, Nk = a.Nk;
  const float* vec = static_cast<const float*>(SET ? a.delta : a.lse) + ((size_t)b * a.H + h) * Nq;
  bool key_ok[R];  // set 0: the thread's keys valid (MASKED)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    key_ok[r] = true;
    if constexpr (MASKED && SET == 0) {
      const int key = k0 + r0 + r;
      key_ok[r] = key >= Nk || static_cast<const uint8_t*>(a.kvm)[(size_t)b * Nk + key];
    }
  }
  float acc[R][COLS];  // set 0: dV, set 1: dK
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int s = it % S, q0 = it * BT;
    float e[NI];  // set 0: lse, set 1: delta of q row cg + 8i (0 past Nq), hidden by the scores
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int row = q0 + cg + 8 * i;
      e[i] = row < Nq ? vec[row] : 0.f;
    }
    float* sq = sQ + s * G::ST;
    cp_async_wait_group<(S > 1 ? S - 2 : 0)>();
    scale_own<G, C>(sq, a.qscale, tid);  // Qs = q * qscale, once, on this thread's own copies
    __syncthreads();  // tile it in and scaled; every thread is done with tile it - 1
    if constexpr (S > 1) load_q(it + S - 1);
    const float* sd = sD + s * G::ST;
    float sc[R][NI];
    if constexpr (SET == 0) {
      score_one<G, C>(sc, sK, sq + cg * G::LD, r0);
      // p = exp2(s - lse); q rows past Nq get p = 0, masked keys score -1e30
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r)
          sc[r][i] = q0 + cg + 8 * i < Nq ? exp2f((key_ok[r] ? sc[r][i] : -1e30f) - e[i]) : 0.f;
      put_exchange<G>(x, sc, rl, cg);
      bar_arrive(1 + pw, 64);
      __syncwarp();
      accumulate<G, Cols<C>>(acc, x, sd, rl, cg);  // dV += p dO, q rows in order
    } else {
      score_one<G, C>(sc, sV, sd + cg * G::LD, r0);
      jt::bar_sync(1 + pw, 64);  // the partner's p
      // ds = p (dp - delta) into this warp's own slice
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int k = 0; k < R / 4; ++k) {
          const int at = (cg + 8 * i) * G::XW + R * rl + 4 * k;
          const float4 p = *reinterpret_cast<const float4*>(x + at);
          *reinterpret_cast<float4*>(y + at) =
              make_float4(p.x * (sc[4 * k][i] - e[i]), p.y * (sc[4 * k + 1][i] - e[i]),
                          p.z * (sc[4 * k + 2][i] - e[i]), p.w * (sc[4 * k + 3][i] - e[i]));
        }
      __syncwarp();
      accumulate<G, Cols<C>>(acc, y, sq, rl, cg);  // dK += ds Qs, q rows in order
    }
    if constexpr (S == 1) {
      __syncthreads();  // every thread is done with the one stage
      load_q(it + 1);
    }
  }  // the next tile's barrier orders these reads before its p and ds writes
  if constexpr (SET == 0)
    store_rows<Cols<C>, R>(hm_rows<float>(a.dv, a.dv_s, b, h), a.dv_s[2], acc, 1.f, k0 + r0, Nk,
                           cg);
  else
    store_rows<Cols<C>, R>(hm_rows<float>(a.dk, a.dk_s, b, h), a.dk_s[2], acc, INV_LOG2E, k0 + r0,
                           Nk, cg);
}

template <class G, int C, bool MASKED>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
flash_bwd_dkv_f32_split_kernel(const HmArgs a) {
  constexpr int BT = G::BT, S = G::STAGES;
  float* sK = reinterpret_cast<float*>(jt::smem_bytes());
  float* sV = sK + G::SR;
  float* sQ = sV + G::SR;      // stage s at s * ST
  float* sD = sQ + S * G::ST;  // stage s at s * ST
  float* sX = sD + S * G::ST;  // p, a slice a pair
  float* sY = sX + G::SW;      // ds, a slice a pair

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * G::BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pw = warp % G::PAIRS, rl = lane % 4, cg = lane / 4;
  const int Nq = a.Nq, Nk = a.Nk;
  const float* qr = hm_rows<const float>(a.q, a.q_s, b, h);
  const float* dor = hm_rows<const float>(a.dO, a.do_s, b, h);
  const int qs = a.q_s[2], dos = a.do_s[2];
  const int nq = (Nq + BT - 1) / BT;
  if constexpr (MASKED) {  // a block of masked keys: dk = dv = 0 (set 0 stores dv, set 1 dk)
    if (keys_masked<G::BR>(static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk, k0, Nk, lane)) {
      const float zero[G::R][Cols<C>::COLS] = {};
      const bool dv = warp < G::PAIRS;
      store_rows<Cols<C>, G::R>(hm_rows<float>(dv ? a.dv : a.dk, dv ? a.dv_s : a.dk_s, b, h),
                                dv ? a.dv_s[2] : a.dk_s[2], zero, 1.f,
                                k0 + G::R * (4 * pw + rl), Nk, cg);
      return;
    }
  }

  auto load_q = [&](int t) {  // Q and dO of tile t into stage t % S: one group, empty past the end
    if (t < nq) {
      load_tile<G, C>(sQ + (t % S) * G::ST, qr, qs, t * BT, Nq, tid);
      load_tile<G, C>(sD + (t % S) * G::ST, dor, dos, t * BT, Nq, tid);
    }
    jt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < (S > 1 ? S - 1 : 1); ++t) load_q(t);
  load_block<G, C>(sK, hm_rows<const float>(a.k, a.k_s, b, h), a.k_s[2], k0, Nk, 1.f, tid);
  load_block<G, C>(sV, hm_rows<const float>(a.v, a.v_s, b, h), a.v_s[2], k0, Nk, 1.f, tid);
  float* x = sX + pw * BT * G::XW;
  float* y = sY + pw * BT * G::XW;
  if (warp < G::PAIRS)
    dkv_split_set<G, C, MASKED, 0>(a, sK, sV, sQ, sD, x, y, k0, pw, rl, cg, tid, nq, load_q);
  else
    dkv_split_set<G, C, MASKED, 1>(a, sK, sV, sQ, sD, x, y, k0, pw, rl, cg, tid, nq, load_q);
}

// ---- launches ---------------------------------------------------------------
// a.kvm == nullptr launches the unmasked instances

template <int C>
int launch_fwd(const HmArgs& a, void* stream) {
  const dim3 grid((a.Nq + F32_BQ - 1) / F32_BQ, a.H, a.B);
  return jt::launch(a.kvm ? flash_fwd_f32_kernel<C, true> : flash_fwd_f32_kernel<C, false>,
                    grid, F32_THREADS, F32Geo<C>::SMEM, stream, a);
}

template <int C, class G = DqGeo<C>>
int launch_dq(const HmArgs& a, void* stream) {
  const dim3 grid((a.Nq + G::BR - 1) / G::BR, a.H, a.B);
  if constexpr (G::SPLIT)
    return jt::launch(a.kvm ? flash_bwd_dq_f32_split_kernel<G, C, true>
                            : flash_bwd_dq_f32_split_kernel<G, C, false>,
                      grid, G::THREADS, G::DQ_SMEM, stream, a);
  else
    return jt::launch(
        a.kvm ? flash_bwd_dq_f32_kernel<G, C, true> : flash_bwd_dq_f32_kernel<G, C, false>, grid,
        G::THREADS, G::DQ_SMEM, stream, a);
}

// kDQ: then the finish pass, dq = scale * the slabs summed in k-block order
template <int C, bool kDQ, class G = std::conditional_t<kDQ, DqkvGeo<C>, DkvGeo<C>>>
int launch_dkv(const HmArgs& a, void* stream) {
  static_assert(!(kDQ && G::SPLIT), "launch_dkv: the dq partials take the unsplit kernel");
  const dim3 grid((a.Nk + G::BR - 1) / G::BR, a.H, a.B);
  if constexpr (G::SPLIT) {
    return jt::launch(a.kvm ? flash_bwd_dkv_f32_split_kernel<G, C, true>
                            : flash_bwd_dkv_f32_split_kernel<G, C, false>,
                      grid, G::THREADS, G::SMEM, stream, a);
  } else {
    const int err = jt::launch(a.kvm ? flash_bwd_dkv_f32_kernel<G, C, true, kDQ>
                                     : flash_bwd_dkv_f32_kernel<G, C, false, kDQ>,
                               grid, G::THREADS, kDQ ? G::DQKV_SMEM : G::SMEM, stream, a);
    if constexpr (kDQ) {
      if (err) return err;
      return launch_dq_finish<C, G::BR, float>(a, stream);
    }
    return err;
  }
}

// HmArgs of the token-major operands: q, k, v the column ranges [0, H*C),
// [H*C, 2*H*C), [2*H*C, 3*H*C) of qkv [B, N, 3*H*C]; o and do [B, N, H*C];
// dq, dk, dv the same column ranges of dqkv (any of them nullptr when the
// entry has none). Returns false when a batch stride passes int.
bool tm_args(HmArgs& a, const void* qkv, const void* kvm, const void* dO, void* o, void* lse,
             const void* delta, void* dqkv, int B, int N, int H, int C, float qscale,
             float scale) {
  const int HC = H * C, rs = 3 * HC;
  if ((long long)N * rs > INT_MAX) return false;
  a = HmArgs{};
  const float* p = static_cast<const float*>(qkv);
  float* d = static_cast<float*>(dqkv);
  a.q = p, a.k = p + HC, a.v = p + 2 * HC, a.kvm = kvm;
  a.o = o, a.dO = dO, a.lse = lse, a.delta = delta;
  a.dq = d, a.dk = d ? d + HC : nullptr, a.dv = d ? d + 2 * HC : nullptr;
  for (int* s : {a.q_s, a.k_s, a.v_s, a.dq_s, a.dk_s, a.dv_s}) {
    s[0] = N * rs, s[1] = C, s[2] = rs;
  }
  for (int* s : {a.o_s, a.do_s}) {
    s[0] = N * HC, s[1] = C, s[2] = HC;
  }
  a.B = B, a.H = H, a.Nq = a.Nk = N, a.qscale = qscale, a.scale = scale;
  return true;
}

}  // namespace
}  // namespace jtf32
