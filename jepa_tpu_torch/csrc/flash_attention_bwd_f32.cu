// H2-fp32: flash self-attention backward over the fused qkv projection,
// fp32 (pretraining with meta.dtype: float32).
//
// Replaces the fp32 instances of jepa_tpu/ops/flash_attention.py's
// _dq_tm_kernel (the dq kernel) and _dkv_tm_kernel (the dk/dv kernel), the
// dual-tiled token-major TPU backward; together the two compute what the
// merged _bwd_tm_kernel does. The kernels are csrc/flash_f32.cuh's FFMA
// backward over the column ranges of qkv (its design, numerics and bound
// are stated there). Same split as H2 (csrc/flash_attention_bwd.cu): no
// atomics, each output element written by one thread in a fixed order, so
// a second call gives the same bits.
//
// Head dims C in {32, 64, 80, 96, 128}: ViT-L's encoder (64), the
// predictors' 24 zero-padded to 32, ViT-H's encoder (80; each thread's
// columns end in a float2 tail), vit_giant's 88 zero-padded to 96, and
// vit_gigantic's 104 padded to 128 and vit_tiny's 384-wide predictor (3
// heads of 128). Geometry per head dim (flash_f32.cuh's DqPick / DkvPick),
// shared memory a block and blocks an SM: the dq kernel owns 64 q rows with
// 128 threads, 43,008 bytes at C=32 (4), 75,776 at C=64 (3), 70,656 at
// C=80 (one stage; 2), 108,544 at C=96 (2); at C=128 it is the split kernel
// (256 threads, one stage), 107,520 (2). The dk/dv kernel is the unsplit
// one at C=32 (64 keys, 128 threads, 43,008 bytes, 4) and the split one
// above: 128 keys with 8 rows x 8 q rows a thread at C=64 (256 threads,
// 208,896 bytes, 1), 64 keys with 256 threads and one stage at C=80, 96 and
// 128 (78,848, 91,136 and 115,712 bytes, 2). Inputs: qkv [B, N, 3*H*C] fp32
// (columns q|k|v, each head-major), an optional key mask kvm [B, N] uint8
// (1 = valid key), do [B, N, H*C] fp32, lse and delta [B, H, N] fp32
// (H1-fp32's base-2 lse; delta = sum_c do*o). Output dqkv [B, N, 3*H*C]
// fp32: the dk/dv kernel writes columns [H*C, 3*H*C), the dq kernel
// columns [0, H*C). A masked key scores -1e30 before p = exp2(s - lse), so
// its dk and dv are exactly 0.
#include "flash_f32.cuh"

#define JT_BWD_F32_ENTRIES(C)                                                   \
  extern "C" int jt_flash_bwd_dkv_f32_c##C(const void* qkv, const void* kvm,    \
                                           const void* dO, const void* lse,     \
                                           const void* delta, void* dqkv,       \
                                           int B, int N, int H, float qscale,   \
                                           void* stream) {                      \
    HmArgs a;                                                                   \
    if (!jtf32::tm_args(a, qkv, kvm, dO, nullptr, (void*)lse, delta, dqkv, B,   \
                        N, H, C, qscale, 0.f))                                  \
      return (int)cudaErrorInvalidValue;                                        \
    return jtf32::launch_dkv<C, false>(a, stream);                              \
  }                                                                             \
  extern "C" int jt_flash_bwd_dq_f32_c##C(const void* qkv, const void* kvm,     \
                                          const void* dO, const void* lse,      \
                                          const void* delta, void* dqkv, int B, \
                                          int N, int H, float qscale,           \
                                          float scale, void* stream) {          \
    HmArgs a;                                                                   \
    if (!jtf32::tm_args(a, qkv, kvm, dO, nullptr, (void*)lse, delta, dqkv, B,   \
                        N, H, C, qscale, scale))                                \
      return (int)cudaErrorInvalidValue;                                        \
    return jtf32::launch_dq<C>(a, stream);                                      \
  }

JT_BWD_F32_ENTRIES(32)
JT_BWD_F32_ENTRIES(64)
JT_BWD_F32_ENTRIES(80)
JT_BWD_F32_ENTRIES(96)
JT_BWD_F32_ENTRIES(128)
