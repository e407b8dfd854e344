"""Port predictor (jepa_tpu_torch.models.predictor) vs the JAX package on
the CPU.

Weights are drawn by the JAX package and carried across with
predictor_state_from_jax; inputs and token indices come from numpy with a
seed. JAX runs first in each test, torch after.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.predictor import init_predictor as jax_init_predictor
from jepa_tpu.models.predictor import predictor_forward as jax_predictor_forward
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.utils.checkpoint_port import port_predictor
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.predictor import Predictor, init_predictor, predictor_forward
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.utils.checkpoint_port import predictor_state_from_jax

GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2, uniform_power=True)


def _cfgs(dtype="float32", attn_impl="xla"):
    jenc = JaxViTCfg(**GEO, embed_dim=64, depth=1, num_heads=4,
                     compute_dtype=getattr(jnp, dtype), attn_impl="xla")
    jcfg = jax_predictor_cfg_for(jenc, predictor_embed_dim=32, depth=2,
                                 zero_init_mask_tokens=False)
    enc = ViTCfg(**GEO, embed_dim=64, depth=1, num_heads=4,
                 compute_dtype=getattr(torch, dtype), attn_impl=attn_impl)
    cfg = predictor_cfg_for(enc, predictor_embed_dim=32, depth=2, zero_init_mask_tokens=False)
    return jcfg, cfg


def _port(params, consts, cfg):
    model = Predictor(cfg)
    sd = predictor_state_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, consts), cfg)
    model.load_state_dict(sd, strict=True)
    return model


def _inputs(seed, k_ctxt=11, k_tgt=14):
    rng = np.random.default_rng(seed)
    ctxt = rng.normal(size=(2, k_ctxt, 64)).astype(np.float32)
    perm = [rng.permutation(32) for _ in range(2)]
    mc = np.stack([np.sort(p[:k_ctxt]) for p in perm]).astype(np.int32)
    mt = np.stack([np.sort(p[k_ctxt:k_ctxt + k_tgt]) for p in perm]).astype(np.int32)
    return ctxt, mc, mt


@pytest.mark.parametrize("mask_index", [0, 1, 3])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_predictor_forward_matches_jax(mask_index, attn_impl):
    """fp32, PARITY.md:11's 2e-4. 'flash' runs the port's flash path (head
    dim 8 zero-padded to 32, plain H1) against JAX's XLA attention."""
    jcfg, cfg = _cfgs(attn_impl=attn_impl)
    params, consts = jax_init_predictor(jax.random.PRNGKey(mask_index), jcfg)
    ctxt, mc, mt = _inputs(mask_index)
    want = np.asarray(jax_predictor_forward(params, consts, jnp.asarray(ctxt), None,
                                            jnp.asarray(mc), jnp.asarray(mt), jcfg,
                                            mask_index=mask_index))

    model = _port(params, consts, cfg)
    with torch.no_grad():
        got = predictor_forward(model, torch.from_numpy(ctxt), torch.from_numpy(mc),
                                torch.from_numpy(mt), mask_index=mask_index)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 14, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_predictor_bf16_matches_jax():
    """bf16 rounds at a few other points (fp32 sums in another order), so
    hold per-token direction, as the encoder's bf16 test does."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    params, consts = jax_init_predictor(jax.random.PRNGKey(5), jcfg)
    ctxt, mc, mt = _inputs(5)
    want = np.array(jax_predictor_forward(params, consts, jnp.asarray(ctxt, jnp.bfloat16),
                                            None, jnp.asarray(mc), jnp.asarray(mt), jcfg))
    model = _port(params, consts, cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(ctxt).bfloat16(), torch.from_numpy(mc),
                    torch.from_numpy(mt))
    cos = torch.nn.functional.cosine_similarity(got, torch.from_numpy(want), dim=-1)
    assert cos.min().item() > 0.999, cos.min().item()


def test_predictor_state_round_trips_through_the_zoo_porter():
    """predictor_state_from_jax gives the reference zoo's names: the JAX
    package's own porter reads them back to the same parameters."""
    jcfg, cfg = _cfgs()
    params, consts = jax_init_predictor(jax.random.PRNGKey(0), jcfg)
    sd = predictor_state_from_jax(jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, consts), cfg)
    back, back_consts = port_predictor({k: v.numpy() for k, v in sd.items()}, jcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(back_consts["pos_embed"]),
                                  np.asarray(consts["pos_embed"]))
    model = init_predictor(cfg, torch.Generator().manual_seed(0))
    assert set(model.state_dict()) == set(sd)
    assert model.mask_tokens[1].shape == (1, 1, 32)


def test_predictor_cfg_for_matches_jax():
    jenc = JaxViTCfg(**GEO, embed_dim=1024, depth=24, num_heads=16)
    want = jax_predictor_cfg_for(jenc, predictor_embed_dim=384, depth=12)
    got = predictor_cfg_for(ViTCfg(**GEO, embed_dim=1024, depth=24, num_heads=16),
                            predictor_embed_dim=384, depth=12)
    for f in dataclasses.fields(got):
        if f.name not in ("compute_dtype",):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.num_patches == want.num_patches


def test_diffusion_mode_is_not_ported():
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError):
        Predictor(dataclasses.replace(cfg, use_mask_tokens=False))
