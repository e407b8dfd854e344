// H2-fp32: flash self-attention backward over the fused qkv projection,
// fp32 (pretraining with meta.dtype: float32).
//
// Replaces the fp32 instances of jepa_tpu/ops/flash_attention.py's
// _dq_tm_kernel (flash_bwd_dq_f32_kernel) and _dkv_tm_kernel
// (flash_bwd_dkv_f32_kernel), the dual-tiled token-major TPU backward;
// together the two compute what the merged _bwd_tm_kernel does. The TPU
// kernels are dtype-generic: every rounding point of the bf16 instance
// (q * (scale*log2e), p as the dV operand, ds before dK and dQ) is a no-op
// in fp32. Same split as H2 (csrc/flash_attention_bwd.cu): no atomics,
// each output element written by one thread in a fixed order, so a second
// call gives the same bits.
//
// Head dims C in {32, 64}: ViT-L's encoder (64) and the predictors' 24
// zero-padded to 32. Inputs: qkv [B, N, 3*H*C] fp32 (read by stride,
// columns q|k|v, each head-major), an optional key mask kvm [B, N] uint8 (1
// = valid key), do [B, N, H*C] fp32, lse and delta [B, H, N] fp32 (H1-fp32's
// base-2 lse; delta = sum_c do*o). Output dqkv [B, N, 3*H*C] fp32: the dk/dv
// kernel writes columns [H*C, 3*H*C), the dq kernel columns [0, H*C).
//
// Masks and edges, as the TPU kernels: a masked key scores -1e30 before
// p = exp2(s - lse), so p = ds = 0 on it and its dk and dv are exactly 0;
// keys past N get p = ds = 0 in the dq kernel and q rows past N get p =
// ds = 0 in the dk/dv kernel (rows past N are zero-filled on load, and a
// zero row scores s = 0, which is no zero weight: the guards stay).
//
// What bounds it on the H100: fp32 has no dense tensor-core path (TF32 is
// not fp32), so the products run on the CUDA cores (FFMA, 66.9 TFLOP/s).
// Per (batch, head) the dq kernel does 3 N x N x C products (S, dP, dQ) and
// the dk/dv kernel 4 (S^T, dP^T, dV, dK): 14*N^2*C flops against
// ~N*C*4*6 bytes, so both are FFMA-bound at the training shapes.
//
// Design (H1-fp32's register-tiled FFMA layout, csrc/flash_attention.cu):
// a block owns 128 rows of one (batch, head) with 256 threads: q rows in
// the dq kernel, keys in the dk/dv kernel. Thread (rg, cg) of warp w (rg =
// 4w + lane%4, cg = lane/4) owns the block's rows 4rg..4rg+3 and, per
// 32-row tile of the streamed operand, its rows cg + 8i (i < 4) and the
// head columns 32g + 4cg.. (g < C/32) of its outputs. The block's two
// operands are stored c-major once ([C][128]); the streamed tiles (32 rows,
// padded to C+4 floats so the 8 column groups fall in 8 bank groups) run
// through a 2-stage cp.async ring, one __syncthreads a tile. Both score
// products (S and dP, or S^T and dP^T) run in one loop over c: per 4 head
// columns 4 float4 of each block operand and 4 of each tile for 128 FFMAs.
// p and ds go to the warp's own [32][16 rows] slices of shared memory (a
// __syncwarp, no block barrier), and the gradient products read them back a
// float4 of 4 rows at a time against a float4 of the tile's columns.
//
//   dq kernel: the block's Q (scaled by qscale) and dO rows; K and V tiles
//   stream. s = Qs k and dp = dO v, p = exp2f(s - lse), ds = p*(dp -
//   delta), dQ += ds k over the keys ascending; dq = dQ * scale at the end.
//
//   dk/dv kernel: the block's K and V rows; Q and dO tiles stream with the
//   tile's lse and delta (4-byte cp.async, zero-filled past N). Each Q
//   stage is scaled by qscale in place behind a second barrier, so both
//   kernels read one Qs. dV += p do and dK += ds Qs over the q rows
//   ascending; dk = dK * (1/log2e) at the end.
//
// Numerics: s, dp = fmaf chains over c ascending from 0, q*qscale rounded
// once; p = exp2f(s - lse), ds = p * (dp - delta); dq and dk/dv each one
// fmaf chain in key (q row) order, scaled once after the sums.
#include "common.cuh"

namespace {

constexpr int BR = 128;      // the block's rows (q rows or keys), 4 a thread
constexpr int BT = 32;       // rows of a streamed tile
constexpr int THREADS = 256; // 8 warps of 4 row groups x 8 column groups
constexpr int STAGES = 2;
constexpr float INV_LOG2E = 0.69314718055994531f;  // 1/log2(e)

template <int C>
struct Geo {
  static constexpr int LD = C + 4;         // padded row of a streamed tile, floats
  static constexpr int SR = C * BR;        // a block operand, c-major [C][128]
  static constexpr int ST = BT * LD;       // a streamed tile [32][C+4]
  static constexpr int SW = 8 * BT * 16;   // p or ds, per warp [32][16 rows]
  static constexpr int NV = C / 32;        // float4 column groups a thread owns (1 or 2)
  static constexpr int COLS = 4 * NV;      // output columns a thread owns
  static constexpr int MINB = C == 32 ? 2 : 1;  // blocks an SM, for the launch bound
  // dq: Qs, dO; K and V tiles; ds
  static constexpr int DQ_SMEM = 4 * (2 * SR + 2 * STAGES * ST + SW);
  // dk/dv: K, V; Qs and dO tiles; lse and delta tiles; p and ds
  static constexpr int DKV_SMEM = 4 * (2 * SR + 2 * STAGES * ST + 2 * STAGES * BT + 2 * SW);
};

// 4 bytes global -> shared (cp.async.ca: the 4-byte form), zero-filled
// when `valid` is false (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + 32) of the columns [col, col + C) of a row-major operand
// (row stride rs floats) into a padded tile, rows past N zero-filled
template <int C>
__device__ __forceinline__ void load_tile(float* dst, const float* base, size_t rs, int col,
                                          int r0, int N, int tid) {
  for (int i = tid; i < BT * C / 4; i += THREADS) {
    const int r = i / (C / 4), c4 = 4 * (i % (C / 4));
    const bool ok = r0 + r < N;
    jt::cp_async16(dst + r * Geo<C>::LD + c4, base + (size_t)(ok ? r0 + r : 0) * rs + col + c4,
                   ok);
  }
}

// the block's rows [r0, r0 + 128) of the columns [col, col + C) of a
// row-major operand, times `mul`, stored c-major (column c at dst + c*128);
// rows past N are zero
template <int C>
__device__ __forceinline__ void load_block(float* dst, const float* base, size_t rs, int col,
                                           int r0, int N, float mul, int tid) {
  for (int i = tid; i < BR * C / 4; i += THREADS) {
    const int r = i % BR, c4 = 4 * (i / BR);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) x = *reinterpret_cast<const float4*>(base + (size_t)(r0 + r) * rs + col + c4);
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
  constexpr int LD = Geo<C>::LD;
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

// the columns 32g + 4cg.. of tile row j (g < C/32)
template <int C>
__device__ __forceinline__ void tile_cols(float (&v)[Geo<C>::COLS], const float* row, int cg) {
#pragma unroll
  for (int g = 0; g < Geo<C>::NV; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(row + 32 * g + 4 * cg);
    v[4 * g] = x.x, v[4 * g + 1] = x.y, v[4 * g + 2] = x.z, v[4 * g + 3] = x.w;
  }
}

// acc[r][...] * mul into the row's columns 32g + 4cg.. (rows past N dropped)
template <int C>
__device__ __forceinline__ void store_rows(float* out, size_t rs, const float (&acc)[4][Geo<C>::COLS],
                                           float mul, int row0, int N, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= N) continue;
    float* o = out + (size_t)(row0 + r) * rs;
#pragma unroll
    for (int g = 0; g < Geo<C>::NV; ++g)
      *reinterpret_cast<float4*>(o + 32 * g + 4 * cg) =
          make_float4(acc[r][4 * g] * mul, acc[r][4 * g + 1] * mul, acc[r][4 * g + 2] * mul,
                      acc[r][4 * g + 3] * mul);
  }
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(THREADS, Geo<C>::MINB)
flash_bwd_dq_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ kvm,
                        const float* __restrict__ dO, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dqkv, int N, int H,
                        float qscale, float scale) {
  using G = Geo<C>;
  float* sQ = reinterpret_cast<float*>(jt::smem_bytes());
  float* sD = sQ + G::SR;
  float* sK = sD + G::SR;                // stage s at s * ST
  float* sV = sK + STAGES * G::ST;       // stage s at s * ST
  float* sS = sV + STAGES * G::ST;       // ds, per warp

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = 4 * (4 * warp + rl);
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;
  const float* base = qkv + (size_t)b * N * rs;
  const int nkv = (N + BT - 1) / BT;

  load_tile<C>(sK, base, rs, HC + h * C, 0, N, tid);
  load_tile<C>(sV, base, rs, 2 * HC + h * C, 0, N, tid);
  jt::cp_async_commit();
  load_block<C>(sQ, base, rs, h * C, q0, N, qscale, tid);
  load_block<C>(sD, dO + (size_t)b * N * HC, HC, h * C, q0, N, 1.f, tid);
  float lr[4], dr[4];  // lse and delta of the thread's rows (0 past N)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + r0 + r;
    const size_t at = ((size_t)b * H + h) * N + row;
    lr[r] = row < N ? lse[at] : 0.f;
    dr[r] = row < N ? delta[at] : 0.f;
  }

  float acc[4][G::COLS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < G::COLS; ++j) acc[r][j] = 0.f;
  float* myds = sS + warp * BT * 16;  // this warp's ds: [key][16 rows]

  for (int it = 0; it < nkv; ++it) {
    const int s = it % STAGES, k0 = it * BT;
    bool key_ok[4];  // key cg + 8i of the tile: below N (and valid, MASKED)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + cg + 8 * i;
      key_ok[i] = key < N;
      if constexpr (MASKED) key_ok[i] = key_ok[i] && kvm[(size_t)b * N + key];
    }
    jt::cp_async_wait_all();
    __syncthreads();  // tile it (and Qs, dO) in; every thread is done with tile it - 1
    if (it + 1 < nkv) {
      const int n = (it + 1) % STAGES;
      load_tile<C>(sK + n * G::ST, base, rs, HC + h * C, k0 + BT, N, tid);
      load_tile<C>(sV + n * G::ST, base, rs, 2 * HC + h * C, k0 + BT, N, tid);
      jt::cp_async_commit();
    }
    const float* sk = sK + s * G::ST;
    float sc[4][4], dp[4][4];
    score_pair<C>(sc, dp, sQ, sD, sk + cg * G::LD, sV + s * G::ST + cg * G::LD, r0);

    // ds = p (dp - delta), p = exp2(s - lse); keys past N and masked keys
    // get ds = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = 0.f;
        if (k0 + cg + 8 * i < N) p = exp2f((key_ok[i] ? sc[r][i] : -1e30f) - lr[r]);
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
  store_rows<C>(dqkv + (size_t)b * N * rs + h * C, rs, acc, scale, q0 + r0, N, cg);
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(THREADS, Geo<C>::MINB)
flash_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ kvm,
                         const float* __restrict__ dO, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dqkv, int N,
                         int H, float qscale) {
  using G = Geo<C>;
  float* sK = reinterpret_cast<float*>(jt::smem_bytes());
  float* sV = sK + G::SR;
  float* sQ = sV + G::SR;                // stage s at s * ST
  float* sD = sQ + STAGES * G::ST;       // stage s at s * ST
  float* sL = sD + STAGES * G::ST;       // lse, stage s at s * BT
  float* sE = sL + STAGES * BT;          // delta, stage s at s * BT
  float* sP = sE + STAGES * BT;          // p, per warp
  float* sS = sP + G::SW;                // ds, per warp

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane % 4, cg = lane / 4, r0 = 4 * (4 * warp + rl);
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;
  const float* base = qkv + (size_t)b * N * rs;
  const float* dbase = dO + (size_t)b * N * HC;
  const float* lrow = lse + ((size_t)b * H + h) * N;
  const float* erow = delta + ((size_t)b * H + h) * N;
  const int nq = (N + BT - 1) / BT;

  auto load_q = [&](int n, int q0) {  // Q, dO, lse, delta of q rows [q0, q0 + 32) into stage n
    load_tile<C>(sQ + n * G::ST, base, rs, h * C, q0, N, tid);
    load_tile<C>(sD + n * G::ST, dbase, HC, h * C, q0, N, tid);
    if (tid < 2 * BT) {
      const int r = tid % BT;
      const bool ok = q0 + r < N;
      cp_async4((tid < BT ? sL : sE) + n * BT + r, (tid < BT ? lrow : erow) + (ok ? q0 + r : 0),
                ok);
    }
    jt::cp_async_commit();
  };
  load_q(0, 0);
  load_block<C>(sK, base, rs, HC + h * C, k0, N, 1.f, tid);
  load_block<C>(sV, base, rs, 2 * HC + h * C, k0, N, 1.f, tid);
  bool key_ok[4];  // the thread's keys: valid (MASKED), else every key
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    key_ok[r] = true;
    if constexpr (MASKED) {
      const int key = k0 + r0 + r;
      key_ok[r] = key < N && kvm[(size_t)b * N + key];
    }
  }

  float dk[4][G::COLS], dv[4][G::COLS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < G::COLS; ++j) dk[r][j] = dv[r][j] = 0.f;
  float* myp = sP + warp * BT * 16;  // this warp's p: [q row][16 keys]
  float* myds = sS + warp * BT * 16;

  for (int it = 0; it < nq; ++it) {
    const int s = it % STAGES, q0 = it * BT;
    jt::cp_async_wait_all();
    __syncthreads();  // tile it (and K, V) in; every thread is done with tile it - 1
    float* sq = sQ + s * G::ST;
    for (int i = tid; i < BT * C; i += THREADS) sq[(i / C) * G::LD + i % C] *= qscale;
    __syncthreads();  // Qs of tile it scaled
    if (it + 1 < nq) load_q((it + 1) % STAGES, q0 + BT);
    const float* sd = sD + s * G::ST;
    float sc[4][4], dp[4][4];
    score_pair<C>(sc, dp, sK, sV, sq + cg * G::LD, sd + cg * G::LD, r0);

    // p = exp2(s - lse), ds = p (dp - delta) for q row cg + 8i; q rows past
    // N and masked keys get p = ds = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = cg + 8 * i;
      const float l = sL[s * BT + j], e = sE[s * BT + j];
      float p[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = 0.f;
        if (q0 + j < N) p[r] = exp2f((key_ok[r] ? sc[r][i] : -1e30f) - l);
        ds[r] = p[r] * (dp[r][i] - e);
      }
      *reinterpret_cast<float4*>(myp + j * 16 + 4 * rl) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(myds + j * 16 + 4 * rl) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncwarp();

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
  float* out = dqkv + (size_t)b * N * rs + h * C;
  store_rows<C>(out + HC, rs, dk, INV_LOG2E, k0 + r0, N, cg);
  store_rows<C>(out + 2 * HC, rs, dv, 1.f, k0 + r0, N, cg);
}

// kvm == nullptr launches the unmasked instances
template <int C>
int launch_dkv(const void* qkv, const void* kvm, const void* dO, const void* lse,
               const void* delta, void* dqkv, int B, int N, int H, float qscale, void* stream) {
  const dim3 grid((N + BR - 1) / BR, H, B);
  return jt::launch(kvm ? flash_bwd_dkv_f32_kernel<C, true> : flash_bwd_dkv_f32_kernel<C, false>,
                    grid, THREADS, Geo<C>::DKV_SMEM, stream, (const float*)qkv,
                    (const uint8_t*)kvm, (const float*)dO, (const float*)lse,
                    (const float*)delta, (float*)dqkv, N, H, qscale);
}

template <int C>
int launch_dq(const void* qkv, const void* kvm, const void* dO, const void* lse,
              const void* delta, void* dqkv, int B, int N, int H, float qscale, float scale,
              void* stream) {
  const dim3 grid((N + BR - 1) / BR, H, B);
  return jt::launch(kvm ? flash_bwd_dq_f32_kernel<C, true> : flash_bwd_dq_f32_kernel<C, false>,
                    grid, THREADS, Geo<C>::DQ_SMEM, stream, (const float*)qkv,
                    (const uint8_t*)kvm, (const float*)dO, (const float*)lse,
                    (const float*)delta, (float*)dqkv, N, H, qscale, scale);
}

}  // namespace

#define JT_BWD_F32_ENTRIES(C)                                                   \
  extern "C" int jt_flash_bwd_dkv_f32_c##C(const void* qkv, const void* kvm,    \
                                           const void* dO, const void* lse,     \
                                           const void* delta, void* dqkv,       \
                                           int B, int N, int H, float qscale,   \
                                           void* stream) {                      \
    return launch_dkv<C>(qkv, kvm, dO, lse, delta, dqkv, B, N, H, qscale,       \
                         stream);                                               \
  }                                                                             \
  extern "C" int jt_flash_bwd_dq_f32_c##C(const void* qkv, const void* kvm,     \
                                          const void* dO, const void* lse,      \
                                          const void* delta, void* dqkv, int B, \
                                          int N, int H, float qscale,           \
                                          float scale, void* stream) {          \
    return launch_dq<C>(qkv, kvm, dO, lse, delta, dqkv, B, N, H, qscale, scale, \
                        stream);                                                \
  }

JT_BWD_F32_ENTRIES(32)
JT_BWD_F32_ENTRIES(64)
