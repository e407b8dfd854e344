"""Port attention backward (FlashSelfAttentionFn with the plain versions of
H1 and H2) vs jax.grad of the JAX package's flash_self_attention in Pallas
interpret mode, on the CPU.

Gradients w.r.t. the block input x, the qkv weight and its bias, at the
encoder's head dim 64 and the predictor's 24 (both packages zero-pad it to
32), at N = 128 and a ragged 149. Inputs come from numpy with a seed; JAX
runs first in each test, torch after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.ops.flash_attention import flash_self_attention as jax_flash_self_attention
from jepa_tpu_torch.models.transformer import matmul_f32
from jepa_tpu_torch.ops import flash_attention as fa

H = 2
# bf16 tolerance, relative to each gradient's largest entry: both packages
# round q, p (as the dV operand), ds and every gradient to bf16, but at
# other points of the sums (and the JAX forward shifts p by a static 64
# where the port takes the row max), so a few elements move by a bf16 ulp
# of a partial sum
BF16_REL = 2.0**-6  # measured: at most 5.6e-3 of the largest entry


def _inputs(n, c, seed):
    rng = np.random.default_rng(seed)
    d = H * 64
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * H * c)) / np.sqrt(d)).astype(np.float32)  # JAX [in, out]
    bias = (0.1 * rng.normal(size=(3 * H * c,))).astype(np.float32)
    r = rng.normal(size=(2, n, H * c)).astype(np.float32)  # cotangent of o
    return x, w, bias, r


@pytest.mark.parametrize("c", [64, 24])
@pytest.mark.parametrize("n", [128, 149])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_matches_jax(c, n, dtype):
    x, w, bias, r = _inputs(n, c, seed=n + c)
    jdt = getattr(jnp, dtype)

    def loss(x_, w_, b_):
        o = jax_flash_self_attention(x_, w_, b_, H, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * r)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                             jnp.asarray(bias))
    want = [np.asarray(g.astype(jnp.float32)) for g in want]

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).to(tdt).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    o = fa.flash_self_attention(xt, wt, bt, H)
    assert o.shape == (2, n, H * c) and o.dtype == tdt
    (o.float() * torch.from_numpy(r)).sum().backward()
    got = [xt.grad.float().numpy(), wt.grad.float().numpy().T, bt.grad.numpy()]
    for name, g, wnt in zip(("dx", "dw", "db"), got, want):
        if dtype == "float32":
            # the JAX package's own flash-gradient tolerance
            # (tests/test_flash_attention.py:67, PARITY.md:13)
            np.testing.assert_allclose(g, wnt, atol=3e-5, rtol=3e-5, err_msg=name)
        else:
            tol = BF16_REL * np.abs(wnt).max()
            np.testing.assert_allclose(g, wnt, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("n", [64, 77])
def test_plain_backward_is_the_softmax_gradient(n):
    """flash_self_attention_bwd_ref against autograd through an fp64 softmax
    attention on the same qkv (the scale and 1/log2e factors, the ragged N)."""
    rng = np.random.default_rng(n)
    b, c = 2, 32
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * H * c)))
    do = torch.from_numpy(rng.normal(size=(b, n, H * c)))
    o, lse = fa.flash_self_attention_ref(qkv.float(), H, c**-0.5)
    delta = fa.attention_delta(do.float(), o, H)
    got = fa.flash_self_attention_bwd_ref(qkv.float(), do.float(), lse, delta, H, c**-0.5)

    q64 = qkv.clone().requires_grad_(True)
    q, k, v = q64.reshape(b, n, 3, H, c).unbind(2)
    s = torch.einsum("bqhc,bkhc->bhqk", q, k) * c**-0.5
    o64 = torch.einsum("bhqk,bkhc->bqhc", s.softmax(-1), v).reshape(b, n, H * c)
    (o64 * do).sum().backward()
    np.testing.assert_allclose(got.numpy(), q64.grad.numpy(), atol=2e-5, rtol=0)
    dk, dv = fa.flash_bwd_dkv_ref(qkv.float(), do.float(), lse, delta, H, c**-0.5)
    assert torch.equal(torch.cat([dk, dv], -1), got[..., H * c:])


def test_padded_head_dim_grads_of_pad_columns_are_zero():
    """c=24 runs at 32: o's pad lanes are sliced off and the qkv weight's pad
    columns (which exist only inside the wrapper) get exactly zero grads,
    so the real weight's gradient is the unpadded one."""
    assert [fa.padded_head_dim(c) for c in (24, 32, 64, 80, 8, 96)] == [32, 32, 64, 80, 32, 96]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 40, 48)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3 * 48, 48)).astype(np.float32) / 7)
    w_pad = torch.nn.functional.pad(w.reshape(3, H, 24, 48), (0, 0, 0, 8))
    w_pad = w_pad.reshape(3 * H * 32, 48).requires_grad_(True)
    qkv = matmul_f32(x, w_pad)
    o = fa.FlashSelfAttentionFn.apply(qkv.contiguous(), H, 24**-0.5)
    o.reshape(1, 40, H, 32)[..., :24].sum().backward()
    pad = w_pad.grad.reshape(3, H, 32, 48)[:, :, 24:]
    assert pad.abs().max().item() == 0.0
    assert w_pad.grad.abs().max().item() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_f32_backward_matches_jax(dtype):
    """The port's linear backward (MatmulF32) against the JAX dot transpose;
    the cotangent is compute-dtype representable, as it is in a linear."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)  # JAX [in, out]
    jdt = getattr(jnp, dtype)
    g = np.array(jnp.asarray(rng.normal(size=(3, 5, 24)), jdt).astype(jnp.float32))

    def f(x_, w_):
        y = jnp.dot(x_, w_, preferred_element_type=jnp.float32)
        return jnp.sum(y * g)

    want = [np.asarray(a.astype(jnp.float32))
            for a in jax.grad(f, argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(w, jdt))]

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).to(tdt).requires_grad_(True)
    y = matmul_f32(xt, wt)
    assert y.dtype == torch.float32
    (y * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    atol = 1e-5 if dtype == "float32" else 2.0**-8 * np.abs(want[1]).max()
    np.testing.assert_allclose(xt.grad.float().numpy(), want[0], atol=atol, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.float().numpy().T, want[1], atol=atol, rtol=1e-5)


def test_backward_wrappers_refuse_cpu_tensors():
    qkv = torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16)
    do = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError):
        fa.flash_bwd_dkv_cuda(qkv, do, lse, lse, torch.empty_like(qkv), 1, 0.125)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq_cuda(qkv, do, lse, lse, torch.empty_like(qkv), 1, 0.125)
