"""Port attention (jepa_tpu_torch.ops) vs the JAX package on the CPU.

The port's plain version of the flash kernel H1 is held against
jepa_tpu's flash_self_attention run in Pallas interpret mode, and the
eager attention against JAX's xla_attention. Inputs come from numpy with
a seed; JAX runs first in each test, torch after.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.ops.attention import xla_attention as jax_xla_attention
from jepa_tpu.ops.flash_attention import flash_self_attention as jax_flash_self_attention
from jepa_tpu_torch.ops import flash_attention as fa
from jepa_tpu_torch.ops.attention import resolve_flash, xla_attention

# bf16: o is rounded to bf16 and p rounds against another shift (static C=64
# in JAX, the row max here): two bf16 ulps at |o| < 2 (measured: one ulp)
BF16_ATOL = 2 * 2.0**-7


def _inputs(b, n, d, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) / np.sqrt(d)).astype(np.float32)  # JAX [in, out]
    bias = (0.1 * rng.normal(size=(3 * d,))).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("n", [128, 149])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_self_attention_matches_jax(n, dtype):
    b, h, c = 2, 2, 64
    d = h * c
    x, w, bias = _inputs(b, n, d, h, seed=n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_flash_self_attention(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                    jnp.asarray(bias), h, interpret=True)
    want = np.asarray(want.astype(jnp.float32))

    tdt = getattr(torch, dtype)
    got = fa.flash_self_attention(torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(w.T.copy()).to(tdt),
                                  torch.from_numpy(bias), h)
    assert got.dtype == tdt and got.shape == (b, n, d)
    atol = 3e-5 if dtype == "float32" else BF16_ATOL  # fp32: PARITY.md:13
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_flash_self_attention_f32_c80_matches_jax():
    """fp32 at head dim 80 (ViT-H, 16 heads), the shape of H1-fp32's c=80
    instance: the token-major route reaches H1's plain version."""
    b, n, h, c = 1, 149, 16, 80
    d = h * c
    x, w, bias = _inputs(b, n, d, h, seed=80)
    want = jax_flash_self_attention(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), h,
                                    interpret=True)
    want = np.asarray(want)

    assert fa.self_attention_route(h, c, n) == "tm"
    with mock.patch.object(fa, "flash_self_attention_ref",
                           wraps=fa.flash_self_attention_ref) as ref:
        got = fa.flash_self_attention(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                      torch.from_numpy(bias), h)
    assert ref.call_count == 1
    assert got.dtype == torch.float32 and got.shape == (b, n, d)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)  # PARITY.md:13


def test_flash_ref_lse_is_base2_logsumexp():
    rng = np.random.default_rng(0)
    b, n, h, c = 1, 37, 2, 64
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * c)).astype(np.float32))
    o, lse = fa.flash_self_attention_ref(qkv, h, c**-0.5)
    q, k, v = qkv.reshape(b, n, 3, h, c).unbind(2)
    s = torch.einsum("bqhc,bkhc->bhqk", q, k) * c**-0.5
    want = torch.logsumexp(s, dim=-1) / np.log(2.0)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)
    o_want = torch.einsum("bhqk,bkhc->bqhc", torch.softmax(s, -1), v).reshape(b, n, h * c)
    np.testing.assert_allclose(o.numpy(), o_want.numpy(), atol=1e-5, rtol=0)


def test_flash_ref_kv_mask_matches_jax():
    b, n, h, c = 2, 128, 2, 64
    d = h * c
    x, w, bias = _inputs(b, n, d, h, seed=3)
    mask = np.ones((b, n), bool)
    mask[0, 100:] = False
    mask[1, 7:40] = False
    want = np.asarray(jax_flash_self_attention(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), h,
        kv_mask=jnp.asarray(mask), interpret=True))
    got = fa.flash_self_attention(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                  torch.from_numpy(bias), h,
                                  kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("nq", [1, 9])
def test_xla_attention_matches_jax(nq):
    rng = np.random.default_rng(nq)
    b, nk, h, c = 2, 50, 3, 16
    q = rng.normal(size=(b, nq, h, c)).astype(np.float32)
    k = rng.normal(size=(b, nk, h, c)).astype(np.float32)
    v = rng.normal(size=(b, nk, h, c)).astype(np.float32)
    mask = rng.random((b, nk)) > 0.3
    want = np.asarray(jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        kv_mask=jnp.asarray(mask)))
    got = xla_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


def test_resolve_flash_rule():
    cpu = torch.zeros(1)
    assert resolve_flash("flash", 1, 1, cpu)
    assert not resolve_flash("xla", 4096, 4096, cpu)
    assert not resolve_flash("auto", 4096, 4096, cpu)  # CUDA tensors only
    with pytest.raises(ValueError):
        resolve_flash("pallas", 128, 128, cpu)


def test_cuda_wrapper_refuses_cpu_tensors():
    qkv = torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_self_attention_cuda(qkv, 1, 0.125)
