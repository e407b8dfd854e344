"""vit_tiny's width (192, 3 heads of 64) through the port's head-major
attention vs the JAX package on the CPU.

vit_tiny has no token-major head split, so both packages run its encoder's
self-attention head-major (flash_self_attention's 'hm' route: K6-K9 in the
JAX package, the plain versions of H4-H7 here), its 384-wide predictor
(3 heads of 128) token-major and its 96-wide predictor (3 heads of 32)
head-major. Weights are carried across with encoder_state_from_jax /
train_state_from_jax; inputs come from numpy with a seed; JAX runs first in
each test, torch after. Tolerances: PARITY.md:11 (forward 2e-4) and the
update's 5e-5 (tests/test_torch_train.py).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.models.vit import init_vit as jax_init_vit
from jepa_tpu.models.vit import vit_forward as jax_vit_forward
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.models.factory import _SPECS, predictor_cfg_for
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, vit_forward
from jepa_tpu_torch.ops import flash_attention as fa
from jepa_tpu_torch.train.step import TrainCfg, build_train_step
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import (
    encoder_state_from_jax,
    predictor_state_from_jax,
    train_state_from_jax,
)

TINY = dict(embed_dim=_SPECS["vit_tiny"][0], num_heads=_SPECS["vit_tiny"][2], depth=2)
_SPIED = ("flash_fwd_hm_ref", "flash_bwd_dqkv_hm_ref", "flash_self_attention_ref")


def _spies():
    """Mocks wrapping the plain versions the routes reach, by name."""
    return {n: mock.patch.object(fa, n, wraps=getattr(fa, n)) for n in _SPIED}


def test_vit_tiny_routes():
    c = TINY["embed_dim"] // TINY["num_heads"]
    assert (TINY["num_heads"], c) == (3, 64)
    assert fa.self_attention_route(3, c, 1568) == "hm"
    assert fa.self_attention_route(3, 384 // 3, 1568) == "tm"
    assert fa.self_attention_route(3, 96 // 3, 1568) == "hm"


def test_vit_tiny_encoder_matches_jax():
    """The encoder forward with attn_impl='flash' (the JAX package in Pallas
    interpret mode), fp32, N = 2 * 4 * 4 = 32 tokens."""
    jcfg = JaxViTCfg(**TINY, img_size=64, patch_size=16, num_frames=4, attn_impl="flash",
                     compute_dtype=jnp.float32)
    params, consts = jax_init_vit(jax.random.PRNGKey(7), jcfg)
    x = np.random.default_rng(7).normal(size=(2, 4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_vit_forward(params, consts, jnp.asarray(x), jcfg))

    cfg = ViTCfg(**TINY, img_size=64, patch_size=16, num_frames=4, attn_impl="flash",
                 compute_dtype=torch.float32)
    model = VisionTransformer(cfg)
    model.load_state_dict(encoder_state_from_jax(jax.tree.map(np.asarray, params),
                                                 jax.tree.map(np.asarray, consts), cfg))
    spies = _spies()
    with spies["flash_fwd_hm_ref"] as fwd, spies["flash_self_attention_ref"] as tm, \
            torch.no_grad():
        got = vit_forward(model, torch.from_numpy(x))
    assert (fwd.call_count, tm.call_count) == (TINY["depth"], 0)
    assert got.shape == want.shape == (2, 32, 192)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)  # PARITY.md:11


B = 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
UPDATE_MASKS = [dict(num_blocks=4, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5]),
                dict(num_blocks=2, spatial_scale=[0.5, 0.5], aspect_ratio=[0.75, 1.5])]
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)


@pytest.mark.parametrize("pred_width", [384, 96])
def test_vit_tiny_update_matches_jax(pred_width):
    """One update of a vit_tiny-width encoder (depth 2) with a 384-wide
    (3 x 128, token-major) or 96-wide (3 x 32, head-major) predictor: the
    port with attn_impl='flash' (the plain versions of H4/H7 for the
    encoder's context and target, of H1/H2 or H4/H7 for the predictor)
    against build_train_step with its XLA attention, fp32."""
    jenc = JaxViTCfg(**GEO, **TINY, uniform_power=True, compute_dtype=jnp.float32,
                     attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=pred_width, depth=2)
    jstate, jconsts = jax_step.init_train_state(jax.random.PRNGKey(13), jenc, jpred)
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    jgrid = jax_masks.MaskGrid(t=2, h=4, w=4)
    keep = [jax_masks.calibrate_keep_counts(s, jgrid, B) for s in jspecs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, jconsts, tc,
                                       *jax_sched.build_schedules(**SCHED), jspecs, jgrid, keep)
    clips = np.random.default_rng(14).normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), jstate["step"], B, jspecs, jgrid, keep)
    jnew, jmetrics = jax.jit(step_fn)(jstate, {"clips": jnp.asarray(clips)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    jstate, jconsts, jnew = to_np(jstate), to_np(jconsts), to_np(jnew)
    jmasks = ([np.asarray(m) for m in me], [np.asarray(m) for m in mp])

    enc = ViTCfg(**GEO, **TINY, uniform_power=True, compute_dtype=torch.float32,
                 attn_impl="flash")
    pred = predictor_cfg_for(enc, predictor_embed_dim=pred_width, depth=2)
    state = train_state_from_jax(jstate, jconsts, enc, pred, device="cpu")
    specs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    injected = lambda step, bs, dev: tuple([torch.from_numpy(np.array(m)).long() for m in ms]
                                           for ms in jmasks)
    port_step = build_train_step(enc, pred, TrainCfg(**TRAIN),
                                 *schedulers.build_schedules(**SCHED), specs, grid, keep,
                                 mask_sampler=injected)
    spies = _spies()
    with spies["flash_fwd_hm_ref"] as fwd, spies["flash_bwd_dqkv_hm_ref"] as bwd, \
            spies["flash_self_attention_ref"] as tm:
        state, metrics = port_step(state, {"clips": torch.from_numpy(clips)})
    # per mask config the context's and (96-wide) the predictor's blocks run
    # head-major forward and backward; the target's blocks forward only
    per_mask = TINY["depth"] + (2 if pred_width == 96 else 0)
    assert fwd.call_count == TINY["depth"] + 2 * per_mask
    assert bwd.call_count == 2 * per_mask
    assert tm.call_count == (2 * 2 if pred_width == 384 else 0)

    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=2e-4)
    for k in ("enc_grad_norm", "pred_grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)
    checks = [(state.encoder, encoder_state_from_jax(jnew["params"]["encoder"],
                                                     jconsts["encoder"], enc)),
              (state.predictor, predictor_state_from_jax(jnew["params"]["predictor"],
                                                         jconsts["predictor"], pred)),
              (state.target, encoder_state_from_jax(jnew["target"], jconsts["encoder"], enc))]
    for module, want_sd in checks:
        got_sd = module.state_dict()
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)


# padded mode at vit_tiny's heads with contexts of >= 128 tokens: 96 px at
# patch 8 over 4 frames (a 2 x 12 x 12 grid, 288 tokens), one small-block
# mask config, the collator's masks padded past their K (a ragged key mask)
PAD_GEO = dict(img_size=96, patch_size=8, num_frames=4, tubelet_size=2)
PAD_GRID = dict(t=2, h=12, w=12)
PAD_MASKS = [dict(num_blocks=2, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5])]
PAD_TRAIN = dict(TRAIN, reg_coeff=0.1, mask_mode="padded")


@pytest.mark.parametrize("pred_width", [384, 96])
def test_vit_tiny_padded_update_matches_jax(pred_width):
    """One padded-mode update, fp32, of a vit_tiny-width encoder (depth 2)
    whose contexts hold >= 128 tokens, with the 384-wide (token-major) or
    96-wide (head-major) predictor: the port with attn_impl='flash' takes
    the 'hm' route with the key mask (the masked plain versions of
    H4-fp32 / H7-fp32, and of H1-fp32 / H2-fp32 at c=128 for the 384-wide
    predictor) against build_train_step(mask_mode='padded') with its XLA
    attention on the same state, clips and padded masks (loss rtol 2e-4,
    parameters atol 5e-5)."""
    from jepa_tpu.masks import padding as jax_padding

    jenc = JaxViTCfg(**PAD_GEO, **TINY, uniform_power=True, compute_dtype=jnp.float32,
                     attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=pred_width, depth=2)
    jstate, jconsts = jax_step.init_train_state(jax.random.PRNGKey(17), jenc, jpred)
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in PAD_MASKS]
    jgrid = jax_masks.MaskGrid(**PAD_GRID)
    keep = [jax_masks.calibrate_keep_counts(s, jgrid, B) for s in jspecs]
    me_list, mp_list = jax_masks.MaskCollator(jspecs, jgrid, seed=7).collate_chunks(B, 1)
    batch = {k: [] for k in ("masks_enc", "enc_weights", "masks_pred", "pred_weights")}
    for (me,), (mp,) in zip(me_list, mp_list):
        assert me.shape[1] >= 128  # the flash rule's floor: the kernels' route on the card
        for m, keys in ((me, ("masks_enc", "enc_weights")), (mp, ("masks_pred", "pred_weights"))):
            idx, w = jax_padding.pad_masks(m, m.shape[1] + 5)
            batch[keys[0]].append(idx)
            batch[keys[1]].append(w)
    clips = np.random.default_rng(18).normal(size=(B, 4, 96, 96, 3)).astype(np.float32)
    tc = jax_step.TrainCfg(**PAD_TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, jconsts, tc,
                                        *jax_sched.build_schedules(**SCHED), jspecs, jgrid, keep)
    jnew, jmetrics = jax.jit(step_fn)(jstate, {"clips": jnp.asarray(clips),
                                               **{k: [jnp.asarray(a) for a in v]
                                                  for k, v in batch.items()}})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    jstate, jconsts, jnew = to_np(jstate), to_np(jconsts), to_np(jnew)

    enc = ViTCfg(**PAD_GEO, **TINY, uniform_power=True, compute_dtype=torch.float32,
                 attn_impl="flash")
    pred = predictor_cfg_for(enc, predictor_embed_dim=pred_width, depth=2)
    state = train_state_from_jax(jstate, jconsts, enc, pred, device="cpu")
    port_step = build_train_step(enc, pred, TrainCfg(**PAD_TRAIN),
                                 *schedulers.build_schedules(**SCHED),
                                 [masks.MaskSpec.from_cfg(m) for m in PAD_MASKS],
                                 masks.MaskGrid(**PAD_GRID), keep)
    spies = _spies()
    with spies["flash_fwd_hm_ref"] as fwd, spies["flash_bwd_dqkv_hm_ref"] as bwd, \
            spies["flash_self_attention_ref"] as tm:
        state, metrics = port_step(state, {"clips": torch.from_numpy(clips),
                                           **{k: [torch.from_numpy(a) for a in v]
                                              for k, v in batch.items()}})
    # the context's blocks (and the 96-wide predictor's) head-major with the
    # key mask, forward and backward; the target's blocks forward, unmasked
    per_mask = TINY["depth"] + (2 if pred_width == 96 else 0)
    assert fwd.call_count == TINY["depth"] + per_mask
    assert bwd.call_count == per_mask
    assert all(c.args[4] is not None for c in fwd.call_args_list[TINY["depth"]:])
    assert all(c.args[7] is not None for c in bwd.call_args_list)
    assert tm.call_count == (2 if pred_width == 384 else 0)

    for k in ("loss", "enc_grad_norm", "pred_grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)
    checks = [(state.encoder, encoder_state_from_jax(jnew["params"]["encoder"],
                                                     jconsts["encoder"], enc)),
              (state.predictor, predictor_state_from_jax(jnew["params"]["predictor"],
                                                         jconsts["predictor"], pred)),
              (state.target, encoder_state_from_jax(jnew["target"], jconsts["encoder"], enc))]
    for module, want_sd in checks:
        got_sd = module.state_dict()
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)
