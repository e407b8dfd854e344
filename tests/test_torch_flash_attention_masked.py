"""Port attention with a key mask (the padded mask mode) vs the JAX package
on the CPU: the forward and gradients of FlashSelfAttentionFn over the
plain masked versions of H1 and H2 against jax.grad of the JAX package's
flash_self_attention(..., kv_mask=...) in Pallas interpret mode, with a
tail of pads and with a mid-sequence run (the predictor's mask is
concat(context valid, target valid)). fp32, the JAX suite's flash
tolerance. Inputs come from numpy with a seed; JAX runs first in each
test, torch after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.ops.flash_attention import flash_self_attention as jax_flash_self_attention
from jepa_tpu_torch.ops import flash_attention as fa

H = 2
N = 128
TOL = 3e-5  # fp32 attention forward and grads (PARITY.md:13)


def _mask(kind):
    m = np.ones((2, N), bool)
    if kind == "tail":
        m[0, 100:] = False
        m[1, 77:] = False
    else:  # a run of pads mid-sequence plus a ragged tail
        m[0, 40:64] = False
        m[0, 120:] = False
        m[1, 5:90] = False
        m[1, 127:] = False
    return m


@pytest.mark.parametrize("c", [64, 24])
@pytest.mark.parametrize("kind", ["tail", "mid"])
def test_masked_flash_forward_and_grads_match_jax(c, kind):
    rng = np.random.default_rng(c + len(kind))
    d = H * 64
    x = rng.normal(size=(2, N, d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * H * c)) / np.sqrt(d)).astype(np.float32)  # JAX [in, out]
    bias = (0.1 * rng.normal(size=(3 * H * c,))).astype(np.float32)
    r = rng.normal(size=(2, N, H * c)).astype(np.float32)  # cotangent of o
    mask = _mask(kind)

    def run(x_, w_, b_):
        return jax_flash_self_attention(x_, w_, b_, H, kv_mask=jnp.asarray(mask),
                                        interpret=True)

    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want_o = np.asarray(run(*args))
    want = jax.grad(lambda *a: jnp.sum(run(*a) * r), argnums=(0, 1, 2))(*args)
    want = [np.asarray(g) for g in want]

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    o = fa.flash_self_attention(xt, wt, bt, H, kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=TOL, rtol=0)
    (o * torch.from_numpy(r)).sum().backward()
    got = [xt.grad.numpy(), wt.grad.numpy().T, bt.grad.numpy()]
    for name, g, wnt in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(g, wnt, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["tail", "mid"])
def test_masked_keys_get_zero_dk_dv(kind):
    """Through FlashSelfAttentionFn the masked keys' k and v columns of
    dqkv are exactly 0, and the mask gets no gradient."""
    rng = np.random.default_rng(1)
    c = 32
    mask = torch.from_numpy(_mask(kind))
    qkv = torch.from_numpy(rng.normal(size=(2, N, 3 * H * c)).astype(np.float32))
    qkv.requires_grad_(True)
    o = fa.FlashSelfAttentionFn.apply(qkv, H, c**-0.5, mask)
    o.square().sum().backward()
    kv = qkv.grad.reshape(2, N, 3, H * c)[:, :, 1:]
    assert kv[~mask].abs().max().item() == 0.0
    assert kv[mask].abs().max().item() > 0.0


@pytest.mark.parametrize("n", [64, 77])
def test_plain_masked_backward_is_the_softmax_gradient(n):
    """flash_self_attention_bwd_ref with a key mask against autograd through
    an fp64 softmax attention whose masked scores are -inf."""
    rng = np.random.default_rng(n)
    b, c = 2, 32
    mask = torch.from_numpy(rng.random((b, n)) > 0.4)
    mask[:, 0] = True
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * H * c)))
    do = torch.from_numpy(rng.normal(size=(b, n, H * c)))
    o, lse = fa.flash_self_attention_ref(qkv.float(), H, c**-0.5, mask)
    delta = fa.attention_delta(do.float(), o, H)
    got = fa.flash_self_attention_bwd_ref(qkv.float(), do.float(), lse, delta, H,
                                          c**-0.5, mask)

    q64 = qkv.clone().requires_grad_(True)
    q, k, v = q64.reshape(b, n, 3, H, c).unbind(2)
    s = torch.einsum("bqhc,bkhc->bhqk", q, k) * c**-0.5
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    o64 = torch.einsum("bhqk,bkhc->bqhc", s.softmax(-1), v).reshape(b, n, H * c)
    (o64 * do).sum().backward()
    np.testing.assert_allclose(got.numpy(), q64.grad.numpy(), atol=2e-5, rtol=0)
    dk, dv = fa.flash_bwd_dkv_ref(qkv.float(), do.float(), lse, delta, H, c**-0.5, mask)
    assert torch.equal(torch.cat([dk, dv], -1), got[..., H * c:])


def test_cuda_wrappers_check_the_mask():
    """The kernels' wrappers refuse CPU tensors (the plain versions take
    them) before they look at the mask; the mask's shape is checked."""
    qkv = torch.zeros(1, 8, 3 * 64, dtype=torch.bfloat16)
    mask = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        fa.flash_self_attention_cuda(qkv, 1, 0.125, mask)
    with pytest.raises(ValueError, match="kv_mask"):
        fa._kernel_mask(torch.ones(1, 7, dtype=torch.bool), qkv, "H1")
    got = fa._kernel_mask(mask, qkv, "H1")
    assert got.dtype == torch.uint8 and got.is_contiguous()
