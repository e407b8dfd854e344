// H1: flash self-attention forward over the fused qkv projection, bf16
// (and, at the end of this file, H1-fp32 for fp32 qkv).
//
// Replaces jepa_tpu/ops/flash_attention.py:_fwd_tm_kernel (the one-shot
// token-major TPU kernel) and computes the same math as its kv-blocked
// sibling _fwd_tm_tiled_kernel.
//
// Head dims C in {32, 64, 80}: 64/80 for the encoders, 32 for the
// predictors' 24 zero-padded to 32 (see ops/flash_attention.py).
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
// each 64-key tile by its own bytes, so a run of pads in the middle of the
// sequence is handled like a tail. A tile whose keys are all masked gives
// p = 1 against its own max of -1e30, and the first valid key's max then
// scales those terms by exp2(-1e30 - m) = 0. A row with no valid key gets
// the uniform average (the padded mode never makes one). The mask is a
// template flag: the unmasked instance is the same code as before.
//
// Rounding points mirror the reference: q * (scale*log2e) is rounded to
// bf16 before QK^T; p is rounded to bf16 before PV; the denominator is the
// fp32 sum of the rounded p (the TPU kernel's ones column appended to v).
//
// Softmax: online row max (FlashAttention-2 form), not the TPU kernel's
// static shift C=64. The two agree within bf16 rounding of p over the
// LayerNorm-bounded logit range; the row max is exact at every range and
// needs no denominator clamp.
//
// What bounds it on the H100: at ViT-L (N=1568, H=16, C=64) attention is
// 4*N^2*C flops per head against ~N*C*2*3 bytes, so it is compute-bound;
// the ceiling is the tensor-core rate and the fp32 exp2 throughput of the
// softmax. Design: one block of 4 warps takes 64 query rows of one
// (batch, head); each warp keeps its 16 rows' Q fragments, the 16x64 score
// tile and the output accumulators in registers, so scores and
// probabilities never touch shared or device memory. K/V stream through
// shared memory in 64-key tiles. Products are mma.sync m16n8k16 bf16 with
// fp32 accumulation. This is the simple first kernel: no cp.async
// pipelining, no wgmma/TMA, no ldmatrix (V fragments are gathered from
// shared memory with 16-bit reads); those are later work.
#include "common.cuh"

namespace {

using jt::bf16;

constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int BKV = 64;     // keys per kv step
constexpr int THREADS = 128;
constexpr int PAD = 8;      // shared-memory row padding, bf16 elements

template <int C, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ kvm,
                 bf16* __restrict__ o, float* __restrict__ lse, int N, int H,
                 float qscale) {
  constexpr int LD = C + PAD;
  constexpr int KSTEPS = C / 16;   // contraction steps of QK^T
  constexpr int NT_S = BKV / 8;    // score tiles of 8 keys
  constexpr int NT_O = C / 8;      // output tiles of 8 dims
  constexpr int VEC = C / 8;       // 16-byte vectors per head row
  __shared__ __align__(16) bf16 sQ[BQ * LD];
  __shared__ __align__(16) bf16 sK[BKV * LD];
  __shared__ __align__(16) bf16 sV[BKV * LD];
  __shared__ uint8_t sM[BKV];  // key mask of the tile (MASKED only)

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;  // token row stride of qkv
  const bf16* base = qkv + (size_t)b * N * rs;

  // Q tile, pre-scaled by scale*log2e in fp32 and rounded to bf16
  for (int i = tid; i < BQ * VEC; i += THREADS) {
    const int r = i / VEC, cv = i % VEC, n = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n < N)
      val = *reinterpret_cast<const uint4*>(base + n * rs + h * C + cv * 8);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
    *reinterpret_cast<uint4*>(&sQ[r * LD + cv * 8]) = val;
  }
  __syncthreads();

  const int qr = warp * 16 + g;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    qa[ks][0] = jt::ld32(&sQ[qr * LD + c0]);
    qa[ks][1] = jt::ld32(&sQ[(qr + 8) * LD + c0]);
    qa[ks][2] = jt::ld32(&sQ[qr * LD + c0 + 8]);
    qa[ks][3] = jt::ld32(&sQ[(qr + 8) * LD + c0 + 8]);
  }

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows g and g+8 of this warp's tile: running max, partial denominators
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < N; k0 += BKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BKV * VEC; i += THREADS) {
      const int r = i / VEC, cv = i % VEC, n = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (n < N) {
        const bf16* row = base + n * rs + h * C + cv * 8;
        kv = *reinterpret_cast<const uint4*>(row + HC);
        vv = *reinterpret_cast<const uint4*>(row + 2 * HC);
      }
      *reinterpret_cast<uint4*>(&sK[r * LD + cv * 8]) = kv;
      *reinterpret_cast<uint4*>(&sV[r * LD + cv * 8]) = vv;
    }
    if constexpr (MASKED) {
      if (tid < BKV) sM[tid] = k0 + tid < N ? kvm[(size_t)b * N + k0 + tid] : 0;
    }
    __syncthreads();

    // S = Q K^T (base-2 logits), 16 x 64 per warp
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = &sK[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        jt::mma_16816(s[nt], qa[ks], jt::ld32(krow + ks * 16),
                      jt::ld32(krow + ks * 16 + 8));
    }
    if constexpr (MASKED) {  // masked keys: -1e30 before the row max
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (!sM[nt * 8 + 2 * t + j]) s[nt][j] = s[nt][2 + j] = -1e30f;
    }
    if (k0 + BKV > N) {  // ragged kv edge: keys past N get no weight
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (k0 + nt * 8 + 2 * t + j >= N) s[nt][j] = s[nt][2 + j] = -INFINITY;
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
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

    // p rounded to bf16; the score C-fragments become PV A-fragments
    uint32_t pa[BKV / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      const bf16 p00 = __float2bfloat16(exp2f(s[nt][0] - m0));
      const bf16 p01 = __float2bfloat16(exp2f(s[nt][1] - m0));
      const bf16 p10 = __float2bfloat16(exp2f(s[nt][2] - m1));
      const bf16 p11 = __float2bfloat16(exp2f(s[nt][3] - m1));
      rs0 += __bfloat162float(p00) + __bfloat162float(p01);
      rs1 += __bfloat162float(p10) + __bfloat162float(p11);
      pa[nt / 2][(nt & 1) * 2 + 0] = jt::pack2(p00, p01);
      pa[nt / 2][(nt & 1) * 2 + 1] = jt::pack2(p10, p11);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int ot = 0; ot < NT_O; ++ot) {
      acc[ot][0] *= alpha0;
      acc[ot][1] *= alpha0;
      acc[ot][2] *= alpha1;
      acc[ot][3] *= alpha1;
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const bf16* v0 = &sV[(kk * 16 + 2 * t) * LD + g];
#pragma unroll
      for (int ot = 0; ot < NT_O; ++ot) {
        const bf16* v = v0 + ot * 8;
        const uint32_t b0 = jt::pack2(v[0], v[LD]);
        const uint32_t b1 = jt::pack2(v[8 * LD], v[9 * LD]);
        jt::mma_16816(acc[ot], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + qr, r1 = r0 + 8;
#pragma unroll
  for (int ot = 0; ot < NT_O; ++ot) {
    const int col = h * C + ot * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * N + r0) * HC + col) =
          __floats2bfloat162_rn(acc[ot][0] / l0, acc[ot][1] / l0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * N + r1) * HC + col) =
          __floats2bfloat162_rn(acc[ot][2] / l1, acc[ot][3] / l1);
  }
  if (t == 0) {
    float* lrow = lse + ((size_t)b * H + h) * N;
    if (r0 < N) lrow[r0] = m0 + log2f(l0);
    if (r1 < N) lrow[r1] = m1 + log2f(l1);
  }
}

// kvm == nullptr launches the unmasked instance
template <int C>
int launch(const void* qkv, const void* kvm, void* o, void* lse, int B, int N,
           int H, float qscale, void* stream) {
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  if (kvm)
    flash_fwd_kernel<C, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)qkv, (const uint8_t*)kvm, (bf16*)o, (float*)lse, N, H, qscale);
  else
    flash_fwd_kernel<C, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)qkv, nullptr, (bf16*)o, (float*)lse, N, H, qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// H1-fp32: the same forward for fp32 qkv (the frozen evals with
// optimization.use_bfloat16: false), the fp32 instance of _fwd_tm_kernel.
//
// The reference's rounding points are dtype-generic, and for fp32 they are
// no-ops: q * (scale*log2e) stays fp32, QK^T and PV are fp32 products with
// fp32 sums, p stays fp32. Same base-2 online softmax as above. No key
// mask (no eval passes one; the wrapper raises on a mask).
//
// What bounds it on the H100: fp32 has no dense tensor-core path (TF32 is
// not fp32), so the 4*N^2*C flops per head run on the CUDA cores (FFMA,
// 66.9 TFLOP/s): at ViT-L (N=1568, C=64) the flops are ~1,000 per byte
// moved, so it is FFMA-bound. Design: one thread owns one query row and
// keeps q[C] and the output accumulator o[C] in registers; K/V stream
// through shared memory in 32-key tiles, and every thread of the block
// reads the same K/V element at once (a broadcast, no bank conflicts). The
// 32 scores of a tile stay in registers; the QK^T loop runs c-outer so its
// 32 dot products are independent FFMA chains. A simple first kernel: no
// register tiling over several rows, no cp.async pipelining.
constexpr int F32_ROWS = 128;  // query rows per block, one per thread
constexpr int F32_BKV = 32;    // keys per kv step

template <int C>
__global__ void __launch_bounds__(F32_ROWS)
flash_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                     float* __restrict__ lse, int N, int H, float qscale) {
  constexpr int V4 = C / 4;  // float4 vectors per head row
  __shared__ __align__(16) float sK[F32_BKV * C];
  __shared__ __align__(16) float sV[F32_BKV * C];

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int row = blockIdx.x * F32_ROWS + tid;
  const int HC = H * C;
  const size_t rs = 3 * (size_t)HC;  // token row stride of qkv
  const float* base = qkv + (size_t)b * N * rs;

  float q[C], acc[C];
#pragma unroll
  for (int v = 0; v < V4; ++v) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < N) x = *reinterpret_cast<const float4*>(base + row * rs + h * C + 4 * v);
    q[4 * v] = x.x * qscale;
    q[4 * v + 1] = x.y * qscale;
    q[4 * v + 2] = x.z * qscale;
    q[4 * v + 3] = x.w * qscale;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += F32_BKV) {
    __syncthreads();  // every thread is done with the previous K/V tile
    for (int i = tid; i < F32_BKV * V4; i += F32_ROWS) {
      const int r = i / V4, cv = i % V4, n = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (n < N) {
        const float* src = base + n * rs + h * C + 4 * cv;
        kv = *reinterpret_cast<const float4*>(src + HC);
        vv = *reinterpret_cast<const float4*>(src + 2 * HC);
      }
      *reinterpret_cast<float4*>(&sK[r * C + 4 * cv]) = kv;
      *reinterpret_cast<float4*>(&sV[r * C + 4 * cv]) = vv;
    }
    __syncthreads();

    float s[F32_BKV];
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) s[j] = 0.f;
#pragma unroll
    for (int v = 0; v < V4; ++v) {
#pragma unroll
      for (int j = 0; j < F32_BKV; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&sK[j * C + 4 * v]);
        s[j] = fmaf(q[4 * v], kk.x, s[j]);
        s[j] = fmaf(q[4 * v + 1], kk.y, s[j]);
        s[j] = fmaf(q[4 * v + 2], kk.z, s[j]);
        s[j] = fmaf(q[4 * v + 3], kk.w, s[j]);
      }
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      if (k0 + j >= N) s[j] = -INFINITY;  // ragged kv edge: no weight
      mx = fmaxf(mx, s[j]);
    }
    // key 0 lies in the first tile, so the max is finite from here on
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < F32_BKV; ++j) {
      const float p = exp2f(s[j] - m);
      l += p;
#pragma unroll
      for (int v = 0; v < V4; ++v) {
        const float4 vv = *reinterpret_cast<const float4*>(&sV[j * C + 4 * v]);
        acc[4 * v] = fmaf(p, vv.x, acc[4 * v]);
        acc[4 * v + 1] = fmaf(p, vv.y, acc[4 * v + 1]);
        acc[4 * v + 2] = fmaf(p, vv.z, acc[4 * v + 2]);
        acc[4 * v + 3] = fmaf(p, vv.w, acc[4 * v + 3]);
      }
    }
  }

  if (row < N) {
    const float inv = 1.f / l;
    float* orow = o + ((size_t)b * N + row) * HC + h * C;
#pragma unroll
    for (int v = 0; v < V4; ++v)
      *reinterpret_cast<float4*>(orow + 4 * v) =
          make_float4(acc[4 * v] * inv, acc[4 * v + 1] * inv, acc[4 * v + 2] * inv,
                      acc[4 * v + 3] * inv);
    lse[((size_t)b * H + h) * N + row] = m + log2f(l);
  }
}

template <int C>
int launch_f32(const void* qkv, void* o, void* lse, int B, int N, int H, float qscale,
               void* stream) {
  const dim3 grid((N + F32_ROWS - 1) / F32_ROWS, H, B);
  flash_fwd_f32_kernel<C><<<grid, F32_ROWS, 0, (cudaStream_t)stream>>>(
      (const float*)qkv, (float*)o, (float*)lse, N, H, qscale);
  return (int)cudaGetLastError();
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

#define JT_FWD_F32_ENTRY(C)                                                     \
  extern "C" int jt_flash_fwd_f32_c##C(const void* qkv, void* o, void* lse,     \
                                       int B, int N, int H, float qscale,       \
                                       void* stream) {                          \
    return launch_f32<C>(qkv, o, lse, B, N, H, qscale, stream);                 \
  }

JT_FWD_F32_ENTRY(64)
JT_FWD_F32_ENTRY(80)
