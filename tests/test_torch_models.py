"""Port models (jepa_tpu_torch.models) vs the JAX package on the CPU.

Weights are drawn by the JAX package and carried across with
encoder_state_from_jax / classifier_state_from_jax; inputs come from numpy
with a seed. JAX runs first in each test, torch after.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.models import factory as jax_factory
from jepa_tpu.models import pos_embed as jax_pos_embed
from jepa_tpu.models.attentive import AttentiveCfg as JaxAttentiveCfg
from jepa_tpu.models.attentive import classifier_forward as jax_classifier_forward
from jepa_tpu.models.attentive import init_attentive_classifier as jax_init_classifier
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.models.vit import init_vit as jax_init_vit
from jepa_tpu.models.vit import patchify_video as jax_patchify_video
from jepa_tpu.models.vit import vit_forward as jax_vit_forward
from jepa_tpu.ops.masking import gather_tokens as jax_gather_tokens
from jepa_tpu.utils.checkpoint_port import export_encoder
from jepa_tpu_torch.models import factory, pos_embed
from jepa_tpu_torch.models.attentive import AttentiveCfg, AttentiveClassifier, classifier_forward
from jepa_tpu_torch.models.initializers import residual_rescale, trunc_normal
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, init_vit, patchify_video, vit_forward
from jepa_tpu_torch.ops.masking import apply_masks, gather_tokens
from jepa_tpu_torch.utils.checkpoint_port import classifier_state_from_jax, encoder_state_from_jax

_SMALL = dict(embed_dim=128, depth=2, num_heads=2, img_size=64, num_frames=16)


def _port_cfg(jcfg):
    """The port's ViTCfg with the same fields as a JAX ViTCfg."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ViTCfg)}
    kw["compute_dtype"] = getattr(torch, jnp.dtype(jcfg.compute_dtype).name)
    return ViTCfg(**kw)


def _port_encoder(params, consts, jcfg):
    """A port VisionTransformer holding the JAX encoder's weights."""
    cfg = _port_cfg(jcfg)
    model = VisionTransformer(cfg)
    sd = encoder_state_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, consts), cfg)
    model.load_state_dict(sd, strict=True)
    return model


def _clips(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_encoder_state_from_jax_keys_and_strict_load():
    jcfg = JaxViTCfg(**_SMALL, compute_dtype=jnp.float32)
    params, consts = jax_init_vit(jax.random.PRNGKey(0), jcfg)
    exported = export_encoder(params, consts, jcfg)
    sd = encoder_state_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, consts), _port_cfg(jcfg))
    assert set(sd) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    model = VisionTransformer(_port_cfg(jcfg))
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(exported)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_kernel_slice_matches_jax(dtype):
    """JAX with attn_impl='flash' and fused_mlp='force' runs both Pallas
    kernels in interpret mode (N = 8*4*4 = 128 tokens); the port runs their
    plain versions on the same weights."""
    jdt = getattr(jnp, dtype)
    jcfg = JaxViTCfg(**_SMALL, attn_impl="flash", fused_mlp="force", compute_dtype=jdt)
    params, consts = jax_init_vit(jax.random.PRNGKey(1), jcfg)
    x = _clips((2, 16, 64, 64, 3), seed=1)
    want = np.asarray(jax_vit_forward(params, consts, jnp.asarray(x, jdt), jcfg))

    model = _port_encoder(params, consts, jcfg)
    with torch.no_grad():
        got = vit_forward(model, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 128, 128)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)  # PARITY.md:11
    else:
        # bf16 rounding differs at a few points (the softmax shift, fp32 sums
        # in another order), so hold per-token direction, not values
        cos = torch.nn.functional.cosine_similarity(got, torch.from_numpy(want), dim=-1)
        assert cos.min().item() > 0.999, cos.min().item()


def test_vit_masks_and_image_path_match_jax():
    jcfg = JaxViTCfg(embed_dim=64, depth=1, num_heads=2, img_size=32, patch_size=8,
                     num_frames=1, compute_dtype=jnp.float32)
    params, consts = jax_init_vit(jax.random.PRNGKey(2), jcfg)
    x = _clips((2, 32, 32, 3), seed=2)
    idx = np.stack([np.arange(0, 16, 2), np.arange(15, 7, -1)]).astype(np.int32)
    want = np.asarray(jax_vit_forward(params, consts, jnp.asarray(x), jcfg,
                                      masks=jnp.asarray(idx)))
    want_layers = [np.asarray(a) for a in
                   jax_vit_forward(params, consts, jnp.asarray(x), jcfg, out_layers=[0])]

    model = _port_encoder(params, consts, jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(x), masks=torch.from_numpy(idx))
        layers = model(torch.from_numpy(x), out_layers=[0])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(layers[0].numpy(), want_layers[0], atol=2e-4, rtol=0)


@pytest.mark.parametrize("depth", [1, 2])
def test_classifier_forward_matches_jax(depth):
    jacfg = JaxAttentiveCfg(embed_dim=64, num_heads=4, depth=depth, num_classes=7,
                            compute_dtype=jnp.float32)
    params = jax_init_classifier(jax.random.PRNGKey(3), jacfg)
    feats = _clips((2, 40, 64), seed=3)
    want = np.asarray(jax_classifier_forward(params, jnp.asarray(feats), jacfg))

    acfg = AttentiveCfg(embed_dim=64, num_heads=4, depth=depth, num_classes=7,
                        compute_dtype=torch.float32)
    clf = AttentiveClassifier(acfg)
    clf.load_state_dict(classifier_state_from_jax(jax.tree.map(np.asarray, params), acfg),
                        strict=True)
    with torch.no_grad():
        got = classifier_forward(clf, torch.from_numpy(feats), acfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)  # PARITY.md:14


@pytest.mark.parametrize("uniform_power", [False, True])
def test_pos_embed_matches_jax(uniform_power):
    want3 = jax_pos_embed.get_3d_sincos_pos_embed(1024, 14, 8, uniform_power=uniform_power)
    want2 = jax_pos_embed.get_2d_sincos_pos_embed(192, 7)
    np.testing.assert_array_equal(
        pos_embed.get_3d_sincos_pos_embed(1024, 14, 8, uniform_power=uniform_power), want3)
    np.testing.assert_array_equal(pos_embed.get_2d_sincos_pos_embed(192, 7), want2)


def test_patchify_and_gather_match_jax():
    jcfg = JaxViTCfg(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
    x = _clips((2, 4, 32, 32, 3), seed=4)
    idx = np.random.default_rng(4).integers(0, 32, size=(2, 5)).astype(np.int32)
    want = np.asarray(jax_patchify_video(jnp.asarray(x), jcfg))
    want_g = np.asarray(jax_gather_tokens(jnp.asarray(want), jnp.asarray(idx)))

    got = patchify_video(torch.from_numpy(x), _port_cfg(jcfg))
    np.testing.assert_array_equal(got.numpy(), want)
    got_g = gather_tokens(got, torch.from_numpy(idx))
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    both = apply_masks(got, [torch.from_numpy(idx)] * 2)
    assert both.shape == (4, 5, got.shape[-1])


def test_factory_specs_match_jax():
    for name in jax_factory._SPECS:
        want = jax_factory.vit_cfg(name, num_frames=16, uniform_power=True)
        got = factory.vit_cfg(name, num_frames=16, uniform_power=True)
        for f in ("embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size",
                  "num_patches", "mlp_hidden"):
            assert getattr(got, f) == getattr(want, f), (name, f)
    with pytest.raises(ValueError):
        factory.vit_cfg("vit_colossal")


def test_init_distribution_and_residual_rescale():
    gen = torch.Generator().manual_seed(0)
    w = trunc_normal((512, 512), gen, std=0.02)
    assert abs(w.std().item() - 0.02) < 1e-3 and w.abs().max().item() <= 2.0
    cfg = ViTCfg(embed_dim=64, depth=3, num_heads=2, img_size=32, patch_size=16)
    model = init_vit(cfg, torch.Generator().manual_seed(1))
    for i, blk in enumerate(model.blocks):
        ratio = blk.attn.proj.weight.std() / blk.attn.qkv.weight.std()
        assert abs(ratio.item() * residual_rescale(i + 1) - 1) < 0.15
        assert blk.attn.qkv.bias.abs().max() == 0 and blk.norm1.weight.min() == 1
