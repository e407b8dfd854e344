// Shared device helpers for the port's hand-written Hopper kernels:
// the bf16 tensor-core product (mma.sync m16n8k16, fp32 accumulators),
// bf16 packing, 32-bit shared-memory fragment reads, the tile loads and
// warp-level products of the flash-attention kernels (4 warps a block, 16
// rows a warp), and a launcher for dynamic shared memory.
//
// Fragment layout of mma.m16n8k16.row.col (lane = 4*g + t):
//   A 16x16 row-major: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B 16x8  (k, n):    b0 (k=2t..2t+1, n=g)              b1 (k=2t+8.., n=g)
//   C 16x8  fp32:      c0,c1 (g, 2t..2t+1)               c2,c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // threads of every attention block: 4 warps
constexpr int kPad = 8;        // shared-memory row padding, bf16 elements

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 values, the lower column in the low half (the mma operand order)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the block's dynamic shared memory (one declaration for every kernel)
__device__ __forceinline__ bf16* smem_bf16() {
  extern __shared__ __align__(16) unsigned char jt_smem[];
  return reinterpret_cast<bf16*>(jt_smem);
}

// rows [r0, r0 + ROWS) of one head's C columns (src points at the head's
// first column of row 0, rows `rs` elements apart) into dst [ROWS][C+kPad];
// rows past N are zero; with `scale` != 1 each value is multiplied in fp32
// and rounded back to bf16.
template <int C, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t rs,
                                          int r0, int N, float scale) {
  constexpr int VEC = C / 8, LD = C + kPad;
  for (int i = threadIdx.x; i < ROWS * VEC; i += kThreads) {
    const int r = i / VEC, cv = i % VEC, n = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n < N) val = *reinterpret_cast<const uint4*>(src + (size_t)n * rs + cv * 8);
    if (scale != 1.f) {
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(&dst[r * LD + cv * 8]) = val;
  }
}

// A-fragments (16 rows from `row`, all C columns) of a row-major
// [.][C+kPad] tile
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[C / 16][4], const bf16* s,
                                       int row, int t) {
  constexpr int LD = C + kPad;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    a[ks][0] = ld32(&s[row * LD + c0]);
    a[ks][1] = ld32(&s[(row + 8) * LD + c0]);
    a[ks][2] = ld32(&s[row * LD + c0 + 8]);
    a[ks][3] = ld32(&s[(row + 8) * LD + c0 + 8]);
  }
}

// acc[16 x NB] = A (16 x C) . T^T, T a row-major [NB][C+kPad] tile
template <int C, int NB>
__device__ __forceinline__ void mm_abt(float (&acc)[NB / 8][4],
                                       const uint32_t (&a)[C / 16][4],
                                       const bf16* T, int g, int t) {
  constexpr int LD = C + kPad;
#pragma unroll
  for (int nt = 0; nt < NB / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const bf16* row = &T[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)
      mma_16816(acc[nt], a[ks], ld32(row + ks * 16), ld32(row + ks * 16 + 8));
  }
}

// the same with A's 16 rows (from `row`) read from a row-major
// [.][C+kPad] tile in shared memory, one 16-column step at a time
template <int C, int NB>
__device__ __forceinline__ void mm_abt_s(float (&acc)[NB / 8][4], const bf16* A,
                                         int row, const bf16* T, int g, int t) {
  constexpr int LD = C + kPad;
#pragma unroll
  for (int nt = 0; nt < NB / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    const uint32_t a[4] = {ld32(&A[row * LD + c0]), ld32(&A[(row + 8) * LD + c0]),
                           ld32(&A[row * LD + c0 + 8]), ld32(&A[(row + 8) * LD + c0 + 8])};
#pragma unroll
    for (int nt = 0; nt < NB / 8; ++nt) {
      const bf16* r = &T[(nt * 8 + g) * LD + c0];
      mma_16816(acc[nt], a, ld32(r), ld32(r + 8));
    }
  }
}

// acc[16 x C] += A (16 x NB, as re-packed fragments) . T, T a row-major
// [NB][C+kPad] tile (B-fragments gathered with 16-bit reads)
template <int C, int NB>
__device__ __forceinline__ void mm_ab(float (&acc)[C / 8][4],
                                      const uint32_t (&a)[NB / 16][4],
                                      const bf16* T, int g, int t) {
  constexpr int LD = C + kPad;
#pragma unroll
  for (int kk = 0; kk < NB / 16; ++kk) {
    const bf16* t0 = &T[(kk * 16 + 2 * t) * LD + g];
#pragma unroll
    for (int ot = 0; ot < C / 8; ++ot) {
      const bf16* v = t0 + ot * 8;
      mma_16816(acc[ot], a[kk], pack2(v[0], v[LD]), pack2(v[8 * LD], v[9 * LD]));
    }
  }
}

// write a warp's 16 x C fp32 accumulator rows (r0, r0 + 8) as bf16 * mul
template <int C>
__device__ __forceinline__ void store_rows(bf16* out, size_t rs, int r0, int N,
                                           const float (&acc)[C / 8][4],
                                           float mul, int t) {
#pragma unroll
  for (int ot = 0; ot < C / 8; ++ot) {
    const int col = ot * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * rs + col) =
          __floats2bfloat162_rn(acc[ot][0] * mul, acc[ot][1] * mul);
    if (r0 + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + 8) * rs + col) =
          __floats2bfloat162_rn(acc[ot][2] * mul, acc[ot][3] * mul);
  }
}

// launch kern<<<grid, kThreads, smem, stream>>>(args...), opting in to more
// than 48 KB of dynamic shared memory where it needs it; returns the launch's
// cudaError_t
template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), dim3 grid, int smem, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace jt
