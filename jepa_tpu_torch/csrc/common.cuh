// Shared device helpers for the port's hand-written Hopper kernels:
// the bf16 tensor-core product (mma.sync m16n8k16, fp32 accumulators),
// bf16 packing and 32-bit shared-memory fragment reads.
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

}  // namespace jt
