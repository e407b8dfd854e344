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
// Nk)*C) bytes, so every kernel is FFMA-bound at the training shapes, and
// a kernel that fed every FFMA its operands from shared memory one at a
// time would be bound by the shared-memory pipe instead.
//
// Design (register-tiled, as a SIMT GEMM): a block owns 128 rows of one
// (batch, head) with 256 threads: q rows in the forward and the dq kernel,
// keys in the dk/dv kernel. Thread (rg, cg) of warp w (rg = 4w + lane%4, cg
// = lane/4) owns the block's rows 4rg..4rg+3 and, per 32-row tile of the
// streamed operand, its rows cg + 8i (i < 4) and the head columns 32g +
// 4cg.. (g < C/32; at C=16 and 80, 32*(C/32)+2cg.. too) of its outputs, so a row's 8
// owners sit in one warp. The block's own operands (scaled Qs in the
// forward and the dq kernel, K and V in the dk/dv kernel, dO) are stored
// c-major once ([C][128]); the streamed tiles (32 rows, padded to C+4
// floats so the 8 column groups fall in 8 bank groups) run through a
// 2-stage cp.async ring, one __syncthreads a tile. Per 4 head columns a
// thread loads 4 float4 of the block's operand and 4 of the tile for 64
// FFMAs. p (and ds) go to the warp's own [32][16 rows] slices of shared
// memory (a __syncwarp, no block barrier), and the products with the
// tile's rows read them back a float4 of 4 rows at a time against a float4
// of the tile's columns.
//
//   forward: S = Qs K^T; the row max over the tile by shuffles among the
//   row's 8 owners; p = exp2(s - m); O += P V and l += p in key order.
//   Head dims 16, 32, 64 and 80 ask for two blocks an SM (128 registers a
//   thread); at 96 and 128 the accumulators (48 and 64 a thread) and the
//   shared memory (113 and 145 KB a block) leave room for one.
//
//   dq kernel: S = Qs K^T and dP = dO V^T in one loop over c, p = exp2f(s -
//   lse), ds = p*(dp - delta), dQ += ds K over the keys ascending; dq = dQ
//   * scale at the end.
//
//   dk/dv kernel: K and V of the block; Q and dO tiles stream with the
//   tile's lse and delta (4-byte cp.async, zero-filled past Nq). Each Q
//   stage is scaled by qscale in place behind a second barrier, so both
//   backward kernels read one Qs. dV += p dO and dK += ds Qs over the q rows
//   ascending; dk = dK * (1/log2e) at the end. At C=128 the block takes
//   231,936 of the 232,448 bytes of shared memory a block may have.
//
//   dk/dv kernel with dq partials (kDQ, H7-fp32): K9 sums dq over its key
//   blocks in VMEM scratch because the TPU grid runs in order; Hopper's
//   blocks run in no order, and fp32 atomics would add in a different
//   order each run. So each block (one k-block of 128 keys) also keeps K
//   row-major ([128][C+4]); after a tile's ds (a block barrier: every
//   warp's ds), thread (rg, cg) sums dQ_part = ds K for q row rg of the
//   tile at its columns over the block's 128 keys ascending (a float4 of
//   4 keys' ds, a float4 of each key's columns) and stores it in the
//   k-block's own slab of the workspace ws [ceil(Nk/128), B, H, Nq, C].
//   The finish pass (flash_hm_dq_finish_kernel) sums the slabs in k-block
//   order and scales: deterministic, no atomics.
//
// Numerics, kept to the bit by H1-fp32 and H2-fp32 through the move to
// strided operands (chip_smoke.py --kernel-ab): s, dp = fmaf chains over c
// ascending from 0 with q*qscale rounded once; forward: the max moves every
// 32 keys, alpha = exp2f(m - mx), l = fmaf(l, alpha, p of the tile's first
// key) then += p in key order, acc = acc*alpha then fmaf(p, v, acc) in key
// order, o = acc * (1/l); backward: p = exp2f(s - lse), ds = p * (dp -
// delta), dq and dk/dv each one fmaf chain in key (q row) order, scaled
// once after the sums; H7-fp32's dq = scale * (((P0 + P1) + P2) + ...),
// each P_j one fmaf chain over its 128 keys.
#pragma once

#include <climits>
#include <initializer_list>

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

constexpr int BR = 128;       // the block's rows (q rows or keys), 4 a thread
constexpr int BT = 32;        // rows of a streamed tile
constexpr int B_THREADS = 256;
constexpr int B_STAGES = 2;

template <int C>
struct BwdGeo {
  static constexpr int LD = C + 4;         // padded row of a streamed tile, floats
  static constexpr int SR = C * BR;        // a block operand, c-major [C][128]
  static constexpr int ST = BT * LD;       // a streamed tile [32][C+4]
  static constexpr int SW = 8 * BT * 16;   // p or ds, per warp [32][16 rows]
  static constexpr int NV = C / 32;        // float4 column groups a thread owns (0-4)
  static constexpr int NT = (C % 32) / 8;  // float2 tail columns a thread owns (0; 2 at C=16, 80)
  static constexpr int COLS = 4 * NV + NT; // output columns a thread owns
  static constexpr int MINB = C <= 32 ? 2 : 1;  // blocks an SM, for the launch bound
  // the 8 column groups' float4s and float2 tails cover columns [0, C) exactly
  static_assert(C % 16 == 0 && (NT == 0 || NT == 2) && 8 * COLS == C,
                "BwdGeo: the columns a block owns must cover the head dim exactly");
  // dq: Qs, dO; K and V tiles; ds
  static constexpr int DQ_SMEM = 4 * (2 * SR + 2 * B_STAGES * ST + SW);
  // dk/dv: K, V; Qs and dO tiles; lse and delta tiles; p and ds
  static constexpr int DKV_SMEM = 4 * (2 * SR + 2 * B_STAGES * ST + 2 * B_STAGES * BT + 2 * SW);
  // with dq partials: also K row-major [128][C+4]
  static constexpr int DQKV_SMEM = DKV_SMEM + 4 * BR * LD;
};

// 4 bytes global -> shared (cp.async.ca: the 4-byte form), zero-filled
// when `valid` is false (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + 32) of a head's rows (row stride rs floats) into a padded
// tile, rows past n zero-filled
template <int C>
__device__ __forceinline__ void load_tile(float* dst, const float* rows, int rs, int r0, int n,
                                          int tid) {
  for (int i = tid; i < BT * C / 4; i += B_THREADS) {
    const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
    const bool ok = r0 + r < n;
    jt::cp_async16(dst + r * BwdGeo<C>::LD + c4, rows + (size_t)(ok ? r0 + r : 0) * rs + c4, ok);
  }
}

// the block's rows [r0, r0 + 128) of a head's rows (row stride rs floats),
// times `mul`, stored c-major (column c at dst + c*128); rows past n are zero
template <int C>
__device__ __forceinline__ void load_block(float* dst, const float* rows, int rs, int r0, int n,
                                           float mul, int tid) {
  for (int i = tid; i < BR * C / 4; i += B_THREADS) {
    const int r = i % BR, c4 = 4 * (i / BR);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(rows + (size_t)(r0 + r) * rs + c4);
    dst[(c4 + 0) * BR + r] = x.x * mul;
    dst[(c4 + 1) * BR + r] = x.y * mul;
    dst[(c4 + 2) * BR + r] = x.z * mul;
    dst[(c4 + 3) * BR + r] = x.w * mul;
  }
}

// a[r][i] = sum_c A[c][r0 + r] * X[cg + 8i][c] and b[r][i] = sum_c
// Bm[c][r0 + r] * Y[cg + 8i][c], each an fmaf chain over c ascending from 0:
// A, Bm the block's c-major operands, x, y the tile rows of key / q row cg
// (row cg + 8i at + 8i*LD)
template <int C>
__device__ __forceinline__ void score_pair(float (&a)[4][4], float (&bb)[4][4], const float* A,
                                           const float* Bm, const float* x, const float* y,
                                           int r0) {
  constexpr int LD = BwdGeo<C>::LD;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[r][i] = bb[r][i] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; c += 4) {
    float4 av[4], xv[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) av[cc] = *reinterpret_cast<const float4*>(A + (c + cc) * BR + r0);
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(x + 8 * i * LD + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xc[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        a[0][i] = fmaf(av[cc].x, xc[cc], a[0][i]);
        a[1][i] = fmaf(av[cc].y, xc[cc], a[1][i]);
        a[2][i] = fmaf(av[cc].z, xc[cc], a[2][i]);
        a[3][i] = fmaf(av[cc].w, xc[cc], a[3][i]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) av[cc] = *reinterpret_cast<const float4*>(Bm + (c + cc) * BR + r0);
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(y + 8 * i * LD + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xc[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        bb[0][i] = fmaf(av[cc].x, xc[cc], bb[0][i]);
        bb[1][i] = fmaf(av[cc].y, xc[cc], bb[1][i]);
        bb[2][i] = fmaf(av[cc].z, xc[cc], bb[2][i]);
        bb[3][i] = fmaf(av[cc].w, xc[cc], bb[3][i]);
      }
    }
  }
}

// the columns 32g + 4cg.. (g < C/32) and, at C=16 and 80, 32*(C/32) + 2cg.. of a tile row
template <int C>
__device__ __forceinline__ void tile_cols(float (&v)[BwdGeo<C>::COLS], const float* row, int cg) {
  constexpr int NV = BwdGeo<C>::NV;
#pragma unroll
  for (int g = 0; g < NV; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(row + 32 * g + 4 * cg);
    v[4 * g] = x.x, v[4 * g + 1] = x.y, v[4 * g + 2] = x.z, v[4 * g + 3] = x.w;
  }
  if constexpr (BwdGeo<C>::NT > 0) {
    const float2 x = *reinterpret_cast<const float2*>(row + 32 * NV + 2 * cg);
    v[4 * NV] = x.x, v[4 * NV + 1] = x.y;
  }
}

// v[...] * mul into a row's columns 32g + 4cg.. (and the C=16 / 80 tail 32*(C/32) + 2cg..)
template <int C>
__device__ __forceinline__ void put_cols(float* o, const float* v, float mul, int cg) {
  constexpr int NV = BwdGeo<C>::NV;
#pragma unroll
  for (int g = 0; g < NV; ++g)
    *reinterpret_cast<float4*>(o + 32 * g + 4 * cg) =
        make_float4(v[4 * g] * mul, v[4 * g + 1] * mul, v[4 * g + 2] * mul, v[4 * g + 3] * mul);
  if constexpr (BwdGeo<C>::NT > 0)
    *reinterpret_cast<float2*>(o + 32 * NV + 2 * cg) =
        make_float2(v[4 * NV] * mul, v[4 * NV + 1] * mul);
}

// acc[r][...] * mul into the row's columns (put_cols) of a head's rows
// (row stride rs; rows past n dropped)
template <int C>
__device__ __forceinline__ void store_rows(float* rows, int rs,
                                           const float (&acc)[4][BwdGeo<C>::COLS], float mul,
                                           int row0, int n, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (row0 + r < n) put_cols<C>(rows + (size_t)(row0 + r) * rs, acc[r], mul, cg);
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(B_THREADS, BwdGeo<C>::MINB)
flash_bwd_dq_f32_kernel(const HmArgs a) {
  using G = BwdGeo<C>;
  float* sQ = reinterpret_cast<float*>(jt::smem_bytes());
  float* sD = sQ + G::SR;
  float* sK = sD + G::SR;                // stage s at s * ST
  float* sV = sK + B_STAGES * G::ST;     // stage s at s * ST
  float* sS = sV + B_STAGES * G::ST;     // ds, per warp

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = 4 * (4 * warp + rl);
  const int Nq = a.Nq, Nk = a.Nk;
  const float* kr = hm_rows<const float>(a.k, a.k_s, b, h);
  const float* vr = hm_rows<const float>(a.v, a.v_s, b, h);
  const int ks = a.k_s[2], vs = a.v_s[2];
  const uint8_t* kvm = static_cast<const uint8_t*>(a.kvm) + (size_t)b * Nk;
  const int nkv = (Nk + BT - 1) / BT;

  load_tile<C>(sK, kr, ks, 0, Nk, tid);
  load_tile<C>(sV, vr, vs, 0, Nk, tid);
  jt::cp_async_commit();
  load_block<C>(sQ, hm_rows<const float>(a.q, a.q_s, b, h), a.q_s[2], q0, Nq, a.qscale, tid);
  load_block<C>(sD, hm_rows<const float>(a.dO, a.do_s, b, h), a.do_s[2], q0, Nq, 1.f, tid);
  float lr[4], dr[4];  // lse and delta of the thread's rows (0 past Nq)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + r0 + r;
    const size_t at = ((size_t)b * a.H + h) * Nq + row;
    lr[r] = row < Nq ? static_cast<const float*>(a.lse)[at] : 0.f;
    dr[r] = row < Nq ? static_cast<const float*>(a.delta)[at] : 0.f;
  }

  float acc[4][G::COLS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < G::COLS; ++j) acc[r][j] = 0.f;
  float* myds = sS + warp * BT * 16;  // this warp's ds: [key][16 rows]

  for (int it = 0; it < nkv; ++it) {
    const int s = it % B_STAGES, k0 = it * BT;
    bool key_ok[4];  // key cg + 8i of the tile: below Nk (and valid, MASKED)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + cg + 8 * i;
      key_ok[i] = key < Nk;
      if constexpr (MASKED) key_ok[i] = key_ok[i] && kvm[key];
    }
    jt::cp_async_wait_all();
    __syncthreads();  // tile it (and Qs, dO) in; every thread is done with tile it - 1
    if (it + 1 < nkv) {
      const int n = (it + 1) % B_STAGES;
      load_tile<C>(sK + n * G::ST, kr, ks, k0 + BT, Nk, tid);
      load_tile<C>(sV + n * G::ST, vr, vs, k0 + BT, Nk, tid);
      jt::cp_async_commit();
    }
    const float* sk = sK + s * G::ST;
    float sc[4][4], dp[4][4];
    score_pair<C>(sc, dp, sQ, sD, sk + cg * G::LD, sV + s * G::ST + cg * G::LD, r0);

    // ds = p (dp - delta), p = exp2(s - lse); keys past Nk and masked keys
    // get ds = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = 0.f;
        if (k0 + cg + 8 * i < Nk) p = exp2f((key_ok[i] ? sc[r][i] : -1e30f) - lr[r]);
        ds[r] = p * (dp[r][i] - dr[r]);
      }
      *reinterpret_cast<float4*>(myds + (cg + 8 * i) * 16 + 4 * rl) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();

    // dQ += ds K, keys in order
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(myds + j * 16 + 4 * rl);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
      float k[G::COLS];
      tile_cols<C>(k, sk + j * G::LD, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::COLS; ++c) acc[r][c] = fmaf(d[r], k[c], acc[r][c]);
    }  // the next tile's barrier orders these reads before its ds writes
  }
  store_rows<C>(hm_rows<float>(a.dq, a.dq_s, b, h), a.dq_s[2], acc, a.scale, q0 + r0, Nq, cg);
}

// kDQ: also each tile's dq partial over the block's 128 keys, into the
// block's slab of ws [ceil(Nk/128), B, H, Nq, C]
template <int C, bool MASKED, bool kDQ>
__global__ void __launch_bounds__(B_THREADS, BwdGeo<C>::MINB)
flash_bwd_dkv_f32_kernel(const HmArgs a) {
  using G = BwdGeo<C>;
  float* sK = reinterpret_cast<float*>(jt::smem_bytes());
  float* sV = sK + G::SR;
  float* sQ = sV + G::SR;                // stage s at s * ST
  float* sD = sQ + B_STAGES * G::ST;     // stage s at s * ST
  float* sL = sD + B_STAGES * G::ST;     // lse, stage s at s * BT
  float* sE = sL + B_STAGES * BT;        // delta, stage s at s * BT
  float* sP = sE + B_STAGES * BT;        // p, per warp
  float* sS = sP + G::SW;                // ds, per warp
  float* sKr = sS + G::SW;               // kDQ: K row-major [128][C+4]

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = 4 * (4 * warp + rl);
  const int Nq = a.Nq, Nk = a.Nk;
  const float* qr = hm_rows<const float>(a.q, a.q_s, b, h);
  const float* dor = hm_rows<const float>(a.dO, a.do_s, b, h);
  const float* kr = hm_rows<const float>(a.k, a.k_s, b, h);
  const int qs = a.q_s[2], dos = a.do_s[2], ks = a.k_s[2];
  const float* lrow = static_cast<const float*>(a.lse) + ((size_t)b * a.H + h) * Nq;
  const float* erow = static_cast<const float*>(a.delta) + ((size_t)b * a.H + h) * Nq;
  const int nq = (Nq + BT - 1) / BT;

  auto load_q = [&](int n, int q0) {  // Q, dO, lse, delta of q rows [q0, q0 + 32) into stage n
    load_tile<C>(sQ + n * G::ST, qr, qs, q0, Nq, tid);
    load_tile<C>(sD + n * G::ST, dor, dos, q0, Nq, tid);
    if (tid < 2 * BT) {
      const int r = tid % BT;
      const bool ok = q0 + r < Nq;
      cp_async4((tid < BT ? sL : sE) + n * BT + r, (tid < BT ? lrow : erow) + (ok ? q0 + r : 0),
                ok);
    }
    jt::cp_async_commit();
  };
  load_q(0, 0);
  load_block<C>(sK, kr, ks, k0, Nk, 1.f, tid);
  load_block<C>(sV, hm_rows<const float>(a.v, a.v_s, b, h), a.v_s[2], k0, Nk, 1.f, tid);
  if constexpr (kDQ) {
    for (int i = tid; i < BR * C / 4; i += B_THREADS) {
      const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Nk) x = *reinterpret_cast<const float4*>(kr + (size_t)(k0 + r) * ks + c4);
      *reinterpret_cast<float4*>(sKr + r * G::LD + c4) = x;
    }
  }
  bool key_ok[4];  // the thread's keys: below Nk (and valid, MASKED)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + r0 + r;
    key_ok[r] = key < Nk;
    if constexpr (MASKED)
      key_ok[r] = key_ok[r] && static_cast<const uint8_t*>(a.kvm)[(size_t)b * Nk + key];
  }

  float dk[4][G::COLS], dv[4][G::COLS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < G::COLS; ++j) dk[r][j] = dv[r][j] = 0.f;
  float* myp = sP + warp * BT * 16;  // this warp's p: [q row][16 keys]
  float* myds = sS + warp * BT * 16;

  for (int it = 0; it < nq; ++it) {
    const int s = it % B_STAGES, q0 = it * BT;
    jt::cp_async_wait_all();
    __syncthreads();  // tile it (and K, V) in; every thread is done with tile it - 1
    float* sq = sQ + s * G::ST;
    for (int i = tid; i < BT * C; i += B_THREADS) sq[(i / C) * G::LD + i % C] *= a.qscale;
    __syncthreads();  // Qs of tile it scaled
    if (it + 1 < nq) load_q((it + 1) % B_STAGES, q0 + BT);
    const float* sd = sD + s * G::ST;
    float sc[4][4], dp[4][4];
    score_pair<C>(sc, dp, sK, sV, sq + cg * G::LD, sd + cg * G::LD, r0);

    // p = exp2(s - lse), ds = p (dp - delta) for q row cg + 8i; q rows past
    // Nq, keys past Nk and masked keys get p = ds = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = cg + 8 * i;
      const float l = sL[s * BT + j], e = sE[s * BT + j];
      float p[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = 0.f;
        if (q0 + j < Nq) p[r] = exp2f((key_ok[r] ? sc[r][i] : -1e30f) - l);
        ds[r] = p[r] * (dp[r][i] - e);
      }
      *reinterpret_cast<float4*>(myp + j * 16 + 4 * rl) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(myds + j * 16 + 4 * rl) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    if constexpr (kDQ) {
      __syncthreads();  // every warp's ds of tile it in
      // dQ_part[jq] = sum over the block's keys ascending of ds[jq][key] K[key],
      // for the tile's q row jq of this thread's row group
      const int jq = 4 * warp + rl;
      float dq[G::COLS];
#pragma unroll
      for (int c = 0; c < G::COLS; ++c) dq[c] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < BR; kk += 4) {  // keys kk..kk+3: warp kk/16's slots kk%16..
        const float4 d4 =
            *reinterpret_cast<const float4*>(sS + (kk / 16) * BT * 16 + jq * 16 + kk % 16);
        const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float k[G::COLS];
          tile_cols<C>(k, sKr + (kk + u) * G::LD, cg);
#pragma unroll
          for (int c = 0; c < G::COLS; ++c) dq[c] = fmaf(d[u], k[c], dq[c]);
        }
      }
      if (q0 + jq < Nq) {
        put_cols<C>(a.ws + ((((size_t)blockIdx.x * a.B + b) * a.H + h) * Nq + q0 + jq) * C, dq,
                    1.f, cg);
      }
    } else {
      __syncwarp();
    }

    // dV += p dO, dK += ds Qs, q rows in order
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(myp + j * 16 + 4 * rl);
      const float4 d4 = *reinterpret_cast<const float4*>(myds + j * 16 + 4 * rl);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w}, d[4] = {d4.x, d4.y, d4.z, d4.w};
      float x[G::COLS];
      tile_cols<C>(x, sd + j * G::LD, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::COLS; ++c) dv[r][c] = fmaf(p[r], x[c], dv[r][c]);
      tile_cols<C>(x, sq + j * G::LD, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < G::COLS; ++c) dk[r][c] = fmaf(d[r], x[c], dk[r][c]);
    }  // the next tile's barrier orders these reads before its p and ds writes
  }
  store_rows<C>(hm_rows<float>(a.dk, a.dk_s, b, h), a.dk_s[2], dk, INV_LOG2E, k0 + r0, Nk, cg);
  store_rows<C>(hm_rows<float>(a.dv, a.dv_s, b, h), a.dv_s[2], dv, 1.f, k0 + r0, Nk, cg);
}

// ---- launches ---------------------------------------------------------------
// a.kvm == nullptr launches the unmasked instances

template <int C>
int launch_fwd(const HmArgs& a, void* stream) {
  const dim3 grid((a.Nq + F32_BQ - 1) / F32_BQ, a.H, a.B);
  return jt::launch(a.kvm ? flash_fwd_f32_kernel<C, true> : flash_fwd_f32_kernel<C, false>,
                    grid, F32_THREADS, F32Geo<C>::SMEM, stream, a);
}

template <int C>
int launch_dq(const HmArgs& a, void* stream) {
  const dim3 grid((a.Nq + BR - 1) / BR, a.H, a.B);
  return jt::launch(a.kvm ? flash_bwd_dq_f32_kernel<C, true> : flash_bwd_dq_f32_kernel<C, false>,
                    grid, B_THREADS, BwdGeo<C>::DQ_SMEM, stream, a);
}

// kDQ: then the finish pass, dq = scale * the slabs summed in k-block order
template <int C, bool kDQ>
int launch_dkv(const HmArgs& a, void* stream) {
  const dim3 grid((a.Nk + BR - 1) / BR, a.H, a.B);
  const int err = jt::launch(
      a.kvm ? flash_bwd_dkv_f32_kernel<C, true, kDQ> : flash_bwd_dkv_f32_kernel<C, false, kDQ>,
      grid, B_THREADS, kDQ ? BwdGeo<C>::DQKV_SMEM : BwdGeo<C>::DKV_SMEM, stream, a);
  if constexpr (kDQ) {
    if (err) return err;
    return launch_dq_finish<C, BR, float>(a, stream);
  }
  return err;
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
