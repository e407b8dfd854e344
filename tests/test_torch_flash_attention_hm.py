"""Port head-major flash attention (the plain versions of H4-H7 behind
flash_attention_bhnd / flash_attention_packed / flash_attention and
dot_product_attention(impl='flash')) vs the JAX package's head-major Pallas
kernels K6-K9 in interpret mode, on the CPU; and the port's dispatch rules
(self_attention_route, merged_bwd) vs the JAX package's pickers.

Inputs come from numpy with a seed; JAX runs first in each test, torch
after. Tolerances: fp32 3e-5 for attention and grads (PARITY.md:13); bf16
two ulps at |o| < 2 (tests/test_torch_flash_attention.py), and for grads
2^-6 of each gradient's largest entry (tests/test_torch_flash_attention_bwd.py).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.models.factory import _SPECS as JAX_SPECS
from jepa_tpu.ops import attention as jax_attention
from jepa_tpu.ops import flash_attention as jfa
from jepa_tpu_torch.ops import flash_attention as fa
from jepa_tpu_torch.ops.attention import dot_product_attention

BF16_ATOL = 2 * 2.0**-7
BF16_GRAD_REL = 2.0**-6


def _bhnd(rng, b, h, n, c):
    return rng.normal(size=(b, h, n, c)).astype(np.float32)


def _mask(rng, b, n):
    m = np.ones((b, n), bool)
    m[0, n // 3:n // 3 + n // 5] = False  # a mid-sequence run of pads
    m[-1, n - n // 7:] = False            # a ragged tail of pads
    return m


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _close(got, want, dtype, grad=False):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    elif grad:
        np.testing.assert_allclose(got, want, atol=BF16_GRAD_REL * np.abs(want).max(), rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 32, 64])
def test_bhnd_forward_matches_jax(c, dtype, masked):
    rng = np.random.default_rng(c + masked)
    b, h, nq, nk = 2, 2, 37, 149
    q, k, v = _bhnd(rng, b, h, nq, c), _bhnd(rng, b, h, nk, c), _bhnd(rng, b, h, nk, c)
    mask = _mask(rng, b, nk) if masked else None
    jdt = getattr(jnp, dtype)
    want = jfa.flash_attention_bhnd(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                    kv_mask=None if mask is None else jnp.asarray(mask),
                                    interpret=True)
    want = np.asarray(want.astype(jnp.float32))

    got = fa.flash_attention_bhnd(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  kv_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (b, h, nq, c) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_fully_masked_row_is_the_uniform_average():
    """K6 gives a row with no valid key the average of v (p = 1 against the
    row max -1e30); so does the port's plain version."""
    rng = np.random.default_rng(5)
    q, k, v = _bhnd(rng, 2, 1, 8, 32), _bhnd(rng, 2, 1, 40, 32), _bhnd(rng, 2, 1, 40, 32)
    mask = np.ones((2, 40), bool)
    mask[1] = False
    want = np.asarray(jfa.flash_attention_bhnd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               kv_mask=jnp.asarray(mask), interpret=True))
    got = fa.flash_attention_bhnd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1].mean(1, keepdims=True),
                                                                (1, 8, 32)), atol=1e-5)


# (B, H, N, c, dtype, masked, the backward the JAX rule picks)
_PACKED = [(2, 2, 149, 64, "float32", False, "merged"),
           (2, 2, 149, 32, "float32", True, "merged"),
           (2, 2, 149, 64, "bfloat16", True, "merged"),
           (2, 2, 149, 32, "bfloat16", False, "merged"),
           (1, 1, 376, 64, "bfloat16", False, "merged"),  # vit_tiny's fixed context
           (1, 1, 1568, 32, "float32", False, "split"),
           (1, 1, 1568, 64, "bfloat16", True, "split"),
           (1, 1, 1568, 32, "bfloat16", True, "split"),
           # c=16: vit_small's and vit_base's 96-wide predictors (6 and 12 heads of 16)
           (2, 2, 149, 16, "float32", False, "merged"),
           (2, 2, 149, 16, "float32", True, "merged"),
           (2, 2, 149, 16, "bfloat16", False, "merged"),
           (2, 2, 149, 16, "bfloat16", True, "merged"),
           (1, 1, 1568, 16, "float32", True, "split"),
           (1, 1, 1568, 16, "bfloat16", False, "split")]


@pytest.mark.parametrize("b,h,n,c,dtype,masked,kind", _PACKED,
                         ids=[f"n{p[2]}-c{p[3]}-{p[4]}-{'masked' if p[5] else 'nomask'}-{p[6]}"
                              for p in _PACKED])
def test_packed_forward_and_grads_match_jax(b, h, n, c, dtype, masked, kind):
    rng = np.random.default_rng(n + c)
    qkv = rng.normal(size=(3, b, h, n, c)).astype(np.float32)
    r = rng.normal(size=(b, h, n, c)).astype(np.float32)  # cotangent of o
    mask = _mask(rng, b, n) if masked else None
    jdt = getattr(jnp, dtype)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(x):
        o = jfa.flash_attention_packed(x, kv_mask=jm, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * r), o

    (_, want_o), want_g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(qkv, jdt))
    want_o = np.asarray(want_o.astype(jnp.float32))
    want_g = np.asarray(want_g.astype(jnp.float32))
    assert fa.merged_bwd(n, n, c) == (kind == "merged")

    x = _t(qkv, dtype).requires_grad_(True)
    spies = {k: mock.patch.object(fa, k, wraps=getattr(fa, k)) for k in
             ("flash_bwd_dqkv_hm_ref", "flash_bwd_dq_hm_ref", "flash_bwd_dkv_hm_ref")}
    with spies["flash_bwd_dqkv_hm_ref"] as merged, spies["flash_bwd_dq_hm_ref"] as dq, \
            spies["flash_bwd_dkv_hm_ref"] as dkv:
        o = fa.flash_attention_packed(x, kv_mask=None if mask is None else torch.from_numpy(mask))
        (o.float() * torch.from_numpy(r)).sum().backward()
    assert (merged.call_count, dq.call_count, dkv.call_count) == (
        (1, 0, 0) if kind == "merged" else (0, 1, 1))
    _close(o.detach(), want_o, dtype)
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(x.grad[i], want_g[i], dtype, grad=True)
        if masked and name != "dq":  # masked keys get exactly zero dk, dv
            assert x.grad[i].permute(0, 2, 1, 3)[torch.from_numpy(~mask)].abs().max() == 0


def test_bhnd_grads_match_jax_cross_lengths():
    """flash_attention_bhnd's own Function (separate q, k, v, Nq != Nk, a key
    mask) against jax.grad of the JAX package's; fp32."""
    rng = np.random.default_rng(9)
    b, h, nq, nk, c = 2, 2, 21, 70, 32
    q, k, v = _bhnd(rng, b, h, nq, c), _bhnd(rng, b, h, nk, c), _bhnd(rng, b, h, nk, c)
    r = rng.normal(size=(b, h, nq, c)).astype(np.float32)
    mask = _mask(rng, b, nk)

    def loss(q_, k_, v_):
        o = jfa.flash_attention_bhnd(q_, k_, v_, kv_mask=jnp.asarray(mask), interpret=True)
        return jnp.sum(o * r)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention_bhnd(*ts, kv_mask=torch.from_numpy(mask))
    (o * torch.from_numpy(r)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=3e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_attention_flash_matches_jax(dtype):
    """The probe's geometry: one query token against a masked key sequence,
    token-major [B, N, H, c], through impl='flash' on both sides."""
    rng = np.random.default_rng(11)
    b, nk, h, c = 3, 96, 3, 64
    q = rng.normal(size=(b, 1, h, c)).astype(np.float32)
    k = rng.normal(size=(b, nk, h, c)).astype(np.float32)
    v = rng.normal(size=(b, nk, h, c)).astype(np.float32)
    mask = _mask(rng, b, nk)
    jdt = getattr(jnp, dtype)
    want = jax_attention.dot_product_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        kv_mask=jnp.asarray(mask), impl="flash")
    want = np.asarray(want.astype(jnp.float32))

    spy = mock.patch.object(fa, "flash_fwd_hm_ref", wraps=fa.flash_fwd_hm_ref)
    with spy as fwd:
        got = dot_product_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                    kv_mask=torch.from_numpy(mask), impl="flash")
    assert fwd.call_count == 1 and got.shape == (b, 1, h, c)
    _close(got, want, dtype)


def _jax_route(h, c, n):
    """The route of jepa_tpu's flash_self_attention (:1775-1803) from its pickers."""
    cp = c
    pf, pb = jfa._pick_tm_fwd(h, cp, n), jfa._pick_tm_bwd(h, cp, n)
    if (pf is None or pb is None) and c % 32:
        cp = jfa._round_up(c, 32)
        pf, pb = jfa._pick_tm_fwd(h, cp, n), jfa._pick_tm_bwd(h, cp, n)
    if n > jfa._MAX_NK or pf is None or pb is None:
        return "eager" if n > jfa._PACKED_SAFE_N else "hm"
    return "tm"


_NS = (128, 256, 384, 640, 1109, 1152, 1568, 1664, 2304, 4608)


@pytest.mark.parametrize("model", sorted(JAX_SPECS))
def test_route_table_matches_jax(model):
    dim, heads = JAX_SPECS[model][0], JAX_SPECS[model][2]
    for width in (dim, 384, 96):  # the encoder, the standard and the smoke predictor
        for n in _NS:
            c = width // heads
            assert fa.self_attention_route(heads, c, n) == _jax_route(heads, c, n), \
                (model, width, n)
            if fa.self_attention_route(heads, c, n) == "hm":
                assert fa.merged_bwd(n, n, c) == jfa._merged_fits(
                    n, n, c, jfa._pick_block(n, n, jfa._BWD_TEMP_BUDGET, jfa.DEFAULT_BLOCK_K))


def test_route_of_vit_tiny():
    """vit_tiny's encoder (3 x 64) has no token-major split: head-major up to
    N = 2048 (merged backward up to ~1536, split at 1568-1664), eager past
    it; its 384-wide predictor (3 x 128) is token-major."""
    assert [fa.self_attention_route(3, 64, n) for n in (128, 1568, 2048, 2304)] == \
        ["hm", "hm", "hm", "eager"]
    assert [fa.merged_bwd(n, n, 64) for n in (1109, 1536, 1568, 1664, 2048)] == \
        [True, True, False, False, True]
    assert fa.self_attention_route(3, 128, 1568) == "tm"
    assert fa.self_attention_route(16, 64, 1568) == "tm"  # ViT-L stays on H1/H2
    for nq, nk in ((1, 1568), (37, 149), (1568, 1)):
        assert fa.merged_bwd(nq, nk, 64) == jfa._merged_fits(
            nq, nk, 64, jfa._pick_block(nk, nq, jfa._BWD_TEMP_BUDGET, 512))


def test_outputs_keep_the_token_major_layout():
    """A [3, B, H, N, c] view of the token-major projection: the kernels' o
    (allocated like the q plane) and dqkv (like qkv) come out token-major,
    so the transposes back are views."""
    x = torch.randn(2, 40, 3 * 3 * 32, requires_grad=True)
    qkv = x.view(2, 40, 3, 3, 32).permute(2, 0, 3, 1, 4)
    o = fa._alloc_like(qkv[0])
    assert o.shape == (2, 3, 40, 32) and o.transpose(1, 2).is_contiguous()
    t = fa._alloc_like(qkv)
    assert t.shape == qkv.shape and t.stride() == qkv.stride()
    fa.flash_attention_packed(qkv).sum().backward()
    assert x.grad.is_contiguous() and x.grad.shape == x.shape


def test_hm_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_fwd_hm_cuda(q, q, q, 0.125)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError):
        fa.flash_bwd_dqkv_hm_cuda(q, q, q, q, lse, lse, 0.125)
