// H1: flash self-attention forward over the fused qkv projection, bf16.
//
// Replaces jepa_tpu/ops/flash_attention.py:_fwd_tm_kernel (the one-shot
// token-major TPU kernel) and computes the same math as its kv-blocked
// sibling _fwd_tm_tiled_kernel.
//
// Head dims C in {32, 64, 80}: 64/80 for the encoders, 32 for the
// predictors' 24 zero-padded to 32 (see ops/flash_attention.py).
//
// Inputs: qkv [B, N, 3*H*C] bf16, the projection output read by stride
// (columns q|k|v, each head-major). Outputs: o [B, N, H*C] bf16
// token-major (the input of attn.proj) and lse [B, H, N] fp32 in base-2
// units (m + log2 l), kept for the backward.
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

template <int C>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                 float* __restrict__ lse, int N, int H, float qscale) {
  constexpr int LD = C + PAD;
  constexpr int KSTEPS = C / 16;   // contraction steps of QK^T
  constexpr int NT_S = BKV / 8;    // score tiles of 8 keys
  constexpr int NT_O = C / 8;      // output tiles of 8 dims
  constexpr int VEC = C / 8;       // 16-byte vectors per head row
  __shared__ __align__(16) bf16 sQ[BQ * LD];
  __shared__ __align__(16) bf16 sK[BKV * LD];
  __shared__ __align__(16) bf16 sV[BKV * LD];

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

template <int C>
int launch(const void* qkv, void* o, void* lse, int B, int N, int H,
           float qscale, void* stream) {
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<C><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)o, (float*)lse, N, H, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jt_flash_fwd_c32(const void* qkv, void* o, void* lse, int B,
                                int N, int H, float qscale, void* stream) {
  return launch<32>(qkv, o, lse, B, N, H, qscale, stream);
}

extern "C" int jt_flash_fwd_c64(const void* qkv, void* o, void* lse, int B,
                                int N, int H, float qscale, void* stream) {
  return launch<64>(qkv, o, lse, B, N, H, qscale, stream);
}

extern "C" int jt_flash_fwd_c80(const void* qkv, void* o, void* lse, int B,
                                int N, int H, float qscale, void* stream) {
  return launch<80>(qkv, o, lse, B, N, H, qscale, stream);
}
