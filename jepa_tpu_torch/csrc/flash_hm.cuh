// What the head-major attention kernels share: the launch arguments (HmArgs)
// and the merged backward's second pass, which sums the k-blocks' dq slabs.
// Used by H4-H7 (csrc/flash_attention_hm.cu, bf16) and by the FFMA fp32
// kernels (csrc/flash_f32.cuh: H1-fp32, H2-fp32 and H4-H7-fp32).
#pragma once

#include <type_traits>

#include "common.cuh"

// the launch arguments, field for field ops/flash_attention.py::_HmArgs.
// Every [B, H, N, C] operand is addressed by its (batch, head, row) element
// strides with a contiguous head dim; q, o, do, dq have Nq rows, k, v, dk,
// dv have Nk; lse and delta are [B, H, Nq] fp32, the key mask kvm [B, Nk]
// uint8 (1 = valid; nullptr: unmasked); ws is the merged backward's dq
// workspace [ceil(Nk / KB), B, H, Nq, C] fp32 (KB keys a k-block)
struct HmArgs {
  const void *q, *k, *v, *kvm;
  void* o;
  const void* dO;
  void* lse;
  const void* delta;
  void *dq, *dk, *dv;
  float* ws;
  int B, H, Nq, Nk;
  int q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  float qscale, scale;
};

namespace {

// the [N, C] rows of head h of batch b of a strided operand
template <typename T>
__device__ __forceinline__ T* hm_rows(const void* p, const int* s, int b, int h) {
  return const_cast<T*>(static_cast<const T*>(p)) + (size_t)b * s[0] + (size_t)h * s[1];
}

// the merged backward's second pass: dq = T(scale * the k-block slabs of ws
// summed in k-block order), KB keys a k-block, one thread per 4 columns of
// a row; the slabs are read once (streaming loads), four k-blocks' loads in
// flight at a time
template <int C, int KB, typename T>
__global__ void __launch_bounds__(256) flash_hm_dq_finish_kernel(const HmArgs a) {
  const size_t quads = (size_t)a.B * a.H * a.Nq * (C / 4);
  const size_t i = blockIdx.x * (size_t)256 + threadIdx.x;
  if (i >= quads) return;
  const int nkb = (a.Nk + KB - 1) / KB;
  const float4* p = reinterpret_cast<const float4*>(a.ws) + i;  // [nkb][B][H][Nq][C]
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int kb = 0; kb < nkb; ++kb) {
    const float4 q = __ldcs(p + kb * quads);
    v.x += q.x;
    v.y += q.y;
    v.z += q.z;
    v.w += q.w;
  }
  const size_t row = i / (C / 4);  // (b * H + h) * Nq + n
  const int n = (int)(row % a.Nq), bh = (int)(row / a.Nq);
  T* out = hm_rows<T>(a.dq, a.dq_s, bh / a.H, bh % a.H) + (size_t)n * a.dq_s[2] + (i % (C / 4)) * 4;
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(out) =
        make_float4(v.x * a.scale, v.y * a.scale, v.z * a.scale, v.w * a.scale);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * a.scale, v.y * a.scale);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * a.scale, v.w * a.scale);
    *reinterpret_cast<uint2*>(out) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// the finish pass's launch over every quad of dq
template <int C, int KB, typename T>
int launch_dq_finish(const HmArgs& a, void* stream) {
  const size_t quads = (size_t)a.B * a.H * a.Nq * (C / 4);
  return jt::launch(flash_hm_dq_finish_kernel<C, KB, T>, dim3((unsigned)((quads + 255) / 256)),
                    256, 0, stream, a);
}

}  // namespace
