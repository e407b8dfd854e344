// H4-H7-fp32: head-major flash attention, forward and backward, fp32
// (vit_tiny served, evaluated or pretrained in fp32: its encoder's 3 heads
// of 64 and its 96-wide predictor's 3 heads of 32 have no token-major head
// split; nor has vit_small's 96-wide predictor, 6 heads of 16).
//
// Replaces the fp32 instances of the head-major TPU kernels of
// jepa_tpu/ops/flash_attention.py, which are dtype-generic:
//   H4-fp32 flash_fwd_f32_kernel                  <- _fwd_kernel   (K6, :122)
//   H5-fp32 flash_bwd_dq_f32_kernel               <- _dq_kernel    (K7, :225)
//   H6-fp32 flash_bwd_dkv_f32_kernel              <- _dkv_kernel   (K8, :254)
//   H7-fp32 flash_bwd_dkv_f32_kernel (kDQ) and
//           flash_hm_dq_finish_kernel             <- _dqkv_kernel  (K9, :318)
// They are csrc/flash_f32.cuh's FFMA kernels (H1-fp32's and H2-fp32's)
// addressed through HmArgs (csrc/flash_hm.cuh): q [B, H, Nq, C], k, v [B,
// H, Nk, C] and the outputs by their (batch, head, row) strides with a
// contiguous head dim, so the planes of a packed [3, B, H, N, C] qkv, or a
// permuted view of the token-major projection, are read and written in
// place; lse and delta [B, H, Nq] fp32; the optional key mask kvm [B, Nk]
// uint8. The rows, bases and strides must be multiples of 16 bytes (the
// float4 cp.async copies; ops/flash_attention.py::check_hm_tma_layout with
// 4-byte elements). C in {16, 32, 64}; at C=16 each thread's columns are
// one float2 (Cols: no float4 group, NV = 0), and H5-fp32 / H6-fp32 give a
// thread 8 rows of a 128-row block; at C=64 H6-fp32 is the split dk/dv
// kernel (flash_f32.cuh's DqPick / DkvPick).
//
// K6's epilogue: o = acc / max(l, 1e-30), lse = m + log2(max(l, 1e-30)); a
// row with no valid key gets the uniform average. H7-fp32 (K9's merged
// backward): each 128-key block writes its fp32 dq partial into its own
// slab of ws [ceil(Nk/128), B, H, Nq, C], and the finish pass sums the
// slabs in block order and scales into dq: deterministic, no atomics.
// Masked keys score -1e30, so their dk and dv are exactly 0.
#include "flash_f32.cuh"

#define JT_HM_F32_ENTRIES(C)                                                   \
  extern "C" int jt_flash_hm_fwd_f32_c##C(const HmArgs* a, void* stream) {     \
    return jtf32::launch_fwd<C>(*a, stream);                                   \
  }                                                                            \
  extern "C" int jt_flash_hm_dq_f32_c##C(const HmArgs* a, void* stream) {      \
    return jtf32::launch_dq<C>(*a, stream);                                    \
  }                                                                            \
  extern "C" int jt_flash_hm_dkv_f32_c##C(const HmArgs* a, void* stream) {     \
    return jtf32::launch_dkv<C, false>(*a, stream);                            \
  }                                                                            \
  extern "C" int jt_flash_hm_dqkv_f32_c##C(const HmArgs* a, void* stream) {    \
    return jtf32::launch_dkv<C, true>(*a, stream);                             \
  }

JT_HM_F32_ENTRIES(16)
JT_HM_F32_ENTRIES(32)
JT_HM_F32_ENTRIES(64)
