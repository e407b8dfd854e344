"""The plain fp32 backward of the port's token-major attention (H2-fp32's
plain version, ``flash_self_attention_bwd_ref``) vs the JAX package's fp32
backward kernels in Pallas interpret mode, on the CPU: the dual-tiled K4
(``_dq_tm_kernel``) and K5 (``_dkv_tm_kernel``) driven directly through
``_bwd_tm_tiled`` with 128-row blocks over a ragged N (two steps, the second
21 rows), and the merged K3 (``_bwd_tm_kernel``) that the JAX pickers choose
for these calls. Both sides take the same qkv, do, o and lse (the JAX
forward's), so only the backward is compared. Head dims 24 (zero-padded to
32, 4 heads), 64 (2 heads), 80 (8 heads: ViT-H), 88 (zero-padded to 96, 4
heads: vit_giant; the fewest heads whose width, 640 and 384, the JAX
token-major kernels take in 128-lane groups) and 128 (3 heads: vit_tiny's
384-wide predictor),
unmasked and with a key mask (a tail of pads; a mid-row run and a tail).
Inputs come from numpy with a seed; JAX runs first in each test, torch
after. Last, fp32 head dims no H1-fp32 / H2-fp32 instance has, an fp32
head-major call at a head dim H4-H7-fp32 lacks and head-major operands of
mixed dtypes raise on a (stand-in) CUDA tensor.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.ops import flash_attention as jfa
from jepa_tpu_torch.ops import flash_attention as fa

B, N = 2, 149
TOL = 3e-5  # fp32 attention gradients (the JAX suite's flash tolerance, PARITY.md:13)
# real head dim -> (heads, padded)
GEOMETRY = {24: (4, 32), 64: (2, 64), 80: (8, 80), 88: (4, 96), 128: (3, 128)}


def _mask(kind):
    m = np.ones((B, N), bool)
    if kind == "tail":
        m[0, 120:] = False
        m[1, 77:] = False
    elif kind == "mid":  # the predictor's mask: concat(context valid, target valid)
        m[0, 40:64] = False
        m[0, 140:] = False
        m[1, 5:90] = False
        m[1, 148:] = False
    return m


@pytest.mark.parametrize("kernel", ["K4+K5", "K3"])
@pytest.mark.parametrize("kind", ["none", "tail", "mid"])
@pytest.mark.parametrize("c", [24, 64, 80, 88, 128])
def test_f32_backward_matches_jax_kernels(c, kind, kernel):
    h, cp = GEOMETRY[c]
    rng = np.random.default_rng(c + len(kind) + len(kernel))
    qkv = rng.normal(size=(B, N, 3, h, cp)).astype(np.float32)
    qkv[..., c:] = 0
    qkv = qkv.reshape(B, N, 3 * h * cp)
    do = rng.normal(size=(B, N, h, cp)).astype(np.float32)
    do[..., c:] = 0
    do = do.reshape(B, N, h * cp)
    mask = None if kind == "none" else _mask(kind)
    scale = c**-0.5

    pf = jfa._pick_tm_fwd(h, cp, N)
    pb = jfa._pick_tm_bwd(h, cp, N)
    assert pb[0] == "merged"  # K3 is what the pickers choose here
    if kernel == "K4+K5":
        pb = ("tiled", 1, 128, 128)
    meta = (scale, h, cp, pf, pb, True)
    jmask = None if mask is None else jax.lax.broadcast_in_dim(
        jnp.asarray(mask), (B, jfa._SUBLANES, N), (0, 2))
    o, lse = jfa._fwd_tm(jnp.asarray(qkv), jmask, meta, grad=True)
    want = [np.asarray(g) for g in jfa._bwd_tm(jnp.asarray(qkv), jmask, o, lse,
                                                jnp.asarray(do), meta)]
    o, lse = np.array(o), np.array(lse)  # lse [B, hs, N, heads / hs], base 2

    lse_t = torch.from_numpy(lse).permute(0, 2, 1, 3).reshape(B, N, h).transpose(1, 2)
    do_t = torch.from_numpy(do)
    delta = fa.attention_delta(do_t, torch.from_numpy(o), h)
    got = fa.flash_self_attention_bwd_ref(torch.from_numpy(qkv), do_t, lse_t.contiguous(),
                                          delta, h, scale,
                                          None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    hc = h * cp
    for i, (name, w) in enumerate(zip(("dq", "dk", "dv"), want)):
        g = got[..., i * hc:(i + 1) * hc].numpy()
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
        assert not g.reshape(B, N, h, cp)[..., c:].any(), name  # pad lanes exactly 0
        if mask is not None and name != "dq":
            assert not g[~mask].any(), name  # masked keys: dk = dv = 0 exactly


class _OnTheCard(types.SimpleNamespace):
    """What the wrappers' checks read of a CUDA tensor, up to the head dim."""

    is_cuda = True

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("c", [48, 112])
def test_f32_backward_outside_its_instances_raises(c):
    """An fp32 backward at a head dim H2-fp32 has no instance for (48 and
    112: multiples of 16 that no model's padding reaches) raises
    NotImplementedError on a CUDA tensor before any launch, and never falls
    back to the plain version; H2-fp32 has every head dim H1-fp32 has."""
    qkv = _OnTheCard(dtype=torch.float32, shape=(2, 40, 3 * 16 * c))
    assert c not in fa.F32_BWD_HEAD_DIMS and fa.F32_BWD_HEAD_DIMS == fa.F32_HEAD_DIMS
    for launch in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(NotImplementedError, match="head dim"):
            launch(qkv, None, None, None, None, 16, c**-0.5)


@pytest.mark.parametrize("case", ["fp32 c=48", "bf16 c=48", "fp32 q, bf16 k"])
def test_f32_head_major_outside_its_instances_raises(case):
    """H4-H7 (bf16) and H4-H7-fp32 take head dims 16, 32 and 64: a call at
    another head dim (48: a multiple of 16 that no model's head-major route
    reaches) raises NotImplementedError in either dtype, and operands of two
    dtypes raise ValueError, on a CUDA tensor before any launch; nothing
    falls back to a plain version."""
    c = 64 if case == "fp32 q, bf16 k" else 48
    dt = torch.bfloat16 if case.startswith("bf16") else torch.float32
    q = _OnTheCard(dtype=dt, shape=(2, 3, 40, c))
    k = _OnTheCard(dtype=torch.bfloat16 if c == 64 else dt, shape=(2, 3, 40, c))
    assert fa.HM_F32_HEAD_DIMS == fa.HM_HEAD_DIMS == (16, 32, 64)
    with pytest.raises(NotImplementedError if c == 48 else ValueError,
                       match="head dim" if c == 48 else "one dtype"):
        fa._check_hm("flash_hm_fwd_cuda", q, k, k, None, {})
