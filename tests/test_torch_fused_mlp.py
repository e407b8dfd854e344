"""Port fused fc1 + GELU (jepa_tpu_torch.ops.fused_mlp) vs the JAX package.

linear_gelu_ref, the plain version of the kernel H3, is held against
jepa_tpu's linear_gelu run in Pallas interpret mode; the shapes outside the
kernel's tiling take the plain exact-erf path in both packages. JAX runs
first in each test, torch after.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.ops.fused_mlp import _gelu_fast as jax_gelu_fast
from jepa_tpu.ops.fused_mlp import linear_gelu as jax_linear_gelu
from jepa_tpu_torch.ops import fused_mlp as fm


def _inputs(m, k, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)  # JAX [in, out]
    b = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    return x, w, b


def _port(x, w, b, dtype):
    return fm.linear_gelu(torch.from_numpy(x).to(dtype),
                          torch.from_numpy(w.T.copy()).to(dtype), torch.from_numpy(b))


def test_linear_gelu_fp32_matches_jax():
    x, w, b = _inputs(64, 128, 512, seed=0)
    want = np.asarray(jax_linear_gelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      interpret=True))
    got = _port(x, w, b, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_linear_gelu_bf16_matches_jax():
    """bf16: z is rounded to bf16 before the GELU in both, so a rare flip of
    that rounding (fp32 sums in another order) moves the output by up to
    1.13 ulp of z on top of its own ulp; allow 2^-6 * max(|ref|, 1)."""
    x, w, b = _inputs(64, 128, 512, seed=1)
    want = jax_linear_gelu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                           jnp.asarray(b), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = _port(x, w, b, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert (d <= 2.0**-6 * np.maximum(np.abs(want), 1)).all(), d.max()
    assert (d > 0).mean() < 0.01  # differences are rare rounding flips


@pytest.mark.parametrize("m,k,f", [(64, 96, 512), (64, 128, 384), (4, 128, 512)])
def test_linear_gelu_plain_fallback_shapes(m, k, f):
    """k % 128, f % 256 or m < 8: the plain exact-erf path in both packages."""
    x, w, b = _inputs(m, k, f, seed=m + k + f)
    want = np.asarray(jax_linear_gelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      interpret=True))
    got = _port(x, w, b, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_linear_gelu_leading_dims():
    x, w, b = _inputs(2 * 40, 128, 512, seed=5)
    want = np.asarray(jax_linear_gelu(jnp.asarray(x.reshape(2, 40, 128)), jnp.asarray(w),
                                      jnp.asarray(b), interpret=True))
    got = fm.linear_gelu(torch.from_numpy(x.reshape(2, 40, 128)),
                         torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.shape == (2, 40, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_gelu_fast_and_erf_match_jax():
    z = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax_gelu_fast(jnp.asarray(z)))
    got = fm._gelu_fast(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(z).double()).numpy()
    np.testing.assert_allclose(fm._gelu(torch.from_numpy(z)).numpy(), exact, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(8, 128, dtype=torch.bfloat16)
    w = torch.zeros(256, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fm.linear_gelu_cuda(x, w, torch.zeros(256))
