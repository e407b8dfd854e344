"""The host side of the fp32 attention backward (H2-fp32, H5-H7-fp32) on the
CPU: what the wrappers decide before a launch.

The CUDA kernels (csrc/flash_f32.cuh) fix their own geometry per head dim;
the host decides one thing that fixes bits: H7-fp32's dq is the sum, in
k-block order, of one fmaf chain per 128-key block, each stored in its own
slab of a workspace [ceil(Nk / 128), B, H, Nq, c]. The slab width and the
workspace the wrapper allocates are held here; a different width would give
other dq bits than the JAX package's K9 order the port keeps.
"""

import pytest
import torch

from jepa_tpu_torch.ops import flash_attention as fa

def test_hm_slab_keys_fix_the_partials_width():
    """H7-fp32 sums 128-key partials (one block of its dk/dv kernel each);
    H7 (bf16) 64-key ones (one consumer warpgroup's keys)."""
    assert fa.hm_slab_keys(torch.float32) == 128
    assert fa.hm_slab_keys(torch.bfloat16) == 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dqkv_workspace_has_a_slab_per_key_block(monkeypatch, dtype):
    """``flash_bwd_dqkv_hm_cuda`` hands the merged backward a contiguous fp32
    workspace of ceil(Nk / slab keys) slabs of [B, H, Nq, c], whatever the
    operands' dtype, and outputs laid out like q, k and v: at vit_gigantic's
    context length, whose last slab holds one key of 128 (one of 64 in bf16)."""
    seen = {}
    n = 513
    monkeypatch.setattr(fa, "_launch_hm", lambda kind, *args, **ops: seen.update(kind=kind, **ops))
    b, h, c = 2, 3, 16
    q, k, v, do = (torch.zeros((b, h, n, c), dtype=dtype) for _ in range(4))
    lse = delta = torch.zeros((b, h, n))
    dq, dk, dv = fa.flash_bwd_dqkv_hm_cuda(q, k, v, do, lse, delta, c**-0.5)
    keys = fa.hm_slab_keys(dtype)
    ws = seen["ws"]
    assert seen["kind"] == "dqkv"
    assert ws.dtype == torch.float32 and ws.is_contiguous()
    assert tuple(ws.shape) == (-(-n // keys), b, h, n, c)
    assert (ws.shape[0] - 1) * keys < n <= ws.shape[0] * keys  # the last slab holds a key
    for got, like in ((dq, q), (dk, k), (dv, v)):
        assert got.shape == like.shape and got.dtype == dtype
