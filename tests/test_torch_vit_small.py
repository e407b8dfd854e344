"""vit_small's and vit_base's head counts through the port's update vs the
JAX package on the CPU.

vit_small (384 wide, 6 heads of 64) and vit_base (768 wide, 12 heads of 64)
have token-major head splits, so both packages run their encoders'
self-attention token-major (H1/H2's plain versions here). A 96-wide
predictor takes the encoder's head count (factory.predictor_cfg_for), so
vit_small's has 6 heads of 16: no token-major split at 16 nor at 32, so
both packages run it head-major (K6-K9 in the JAX package, the plain
versions of H4-H7 here) at c=16. vit_base's 384-wide predictor (12 heads of
32) splits token-major. Weights are carried across with
train_state_from_jax; inputs come from numpy with a seed; JAX runs first,
torch after. Tolerances: the update's (tests/test_torch_train.py): loss and
grad norms rtol 2e-4, parameters atol 5e-5.
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
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.models.factory import _SPECS, predictor_cfg_for
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.ops import flash_attention as fa
from jepa_tpu_torch.train.step import TrainCfg, build_train_step
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import (
    encoder_state_from_jax,
    predictor_state_from_jax,
    train_state_from_jax,
)

_SPIED = ("flash_self_attention_ref", "flash_self_attention_bwd_ref", "flash_fwd_hm_ref",
          "flash_bwd_dqkv_hm_ref", "flash_bwd_dq_hm_ref", "flash_bwd_dkv_hm_ref")
B, DEPTH = 2, 2
# 96 px at patch 8 over 4 frames: a 2 x 12 x 12 grid, 288 tokens, so the
# contexts and the predictor's sequences hold >= 128 tokens (the flash rule's
# floor on the card) and the 96-wide predictor takes the head-major route
GEO = dict(img_size=96, patch_size=8, num_frames=4, tubelet_size=2)
GRID = dict(t=2, h=12, w=12)
MASKS = [dict(num_blocks=2, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5])]
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)


def _width(model):
    dim, _, heads, _, _ = _SPECS[model]
    return dict(embed_dim=dim, num_heads=heads, depth=DEPTH)


def test_routes():
    """vit_small's encoder (6 x 64) and vit_base's (12 x 64) split
    token-major; vit_small's 96-wide predictor (6 heads of 16) runs
    head-major up to 2048 tokens, merged up to ~1536; vit_base's 384-wide
    predictor (12 x 32) splits token-major, as does a 96-wide one (12 heads
    of 16 padded to 32)."""
    assert fa.self_attention_route(6, 64, 1568) == fa.self_attention_route(12, 64, 1568) == "tm"
    assert [fa.self_attention_route(6, 16, n) for n in (128, 1664, 2048, 2304)] == \
        ["hm", "hm", "hm", "eager"]
    assert fa.self_attention_route(12, 16, 1109) == "tm" and fa.padded_head_dim(16) == 32
    assert [fa.merged_bwd(n, n, 16) for n in (288, 1109, 1536, 1664)] == [True, True, True, False]
    assert fa.self_attention_route(12, 32, 1568) == "tm"
    assert 16 in fa.HM_HEAD_DIMS and 16 in fa.HM_F32_HEAD_DIMS


@pytest.mark.parametrize("model,pred_width", [("vit_small", 96), ("vit_base", 384)],
                         ids=["vit_small-pred96", "vit_base-pred384"])
def test_update_matches_jax(model, pred_width):
    """One update of a depth-2 encoder at ``model``'s width with a depth-2
    predictor ``pred_width`` wide, fp32: the port with attn_impl='flash'
    (the plain versions of H1/H2 for the encoder; of H4/H7 at c=16 for
    vit_small's 96-wide predictor, of H1/H2 at c=32 for vit_base's 384-wide
    one) against build_train_step with its XLA attention on the same state,
    clips and masks (loss and grad norms rtol 2e-4, parameters atol 5e-5)."""
    width = _width(model)
    jenc = JaxViTCfg(**GEO, **width, uniform_power=True, compute_dtype=jnp.float32,
                     attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=pred_width, depth=DEPTH)
    jstate, jconsts = jax_step.init_train_state(jax.random.PRNGKey(19), jenc, jpred)
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in MASKS]
    jgrid = jax_masks.MaskGrid(**GRID)
    keep = [jax_masks.calibrate_keep_counts(s, jgrid, B) for s in jspecs]
    (ke, kp), = keep
    assert ke >= 128 and ke + kp >= 128  # the kernels' routes on the card
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, jconsts, tc,
                                        *jax_sched.build_schedules(**SCHED), jspecs, jgrid, keep)
    clips = np.random.default_rng(20).normal(size=(B, 4, 96, 96, 3)).astype(np.float32)
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), jstate["step"], B, jspecs, jgrid,
        keep)
    jnew, jmetrics = jax.jit(step_fn)(jstate, {"clips": jnp.asarray(clips)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    jstate, jconsts, jnew = to_np(jstate), to_np(jconsts), to_np(jnew)
    jmasks = ([np.asarray(m) for m in me], [np.asarray(m) for m in mp])

    enc = ViTCfg(**GEO, **width, uniform_power=True, compute_dtype=torch.float32,
                 attn_impl="flash")
    pred = predictor_cfg_for(enc, predictor_embed_dim=pred_width, depth=DEPTH)
    hp, cp = pred.num_heads, pred_width // pred.num_heads
    assert (hp, cp) == {"vit_small": (6, 16), "vit_base": (12, 32)}[model]
    state = train_state_from_jax(jstate, jconsts, enc, pred, device="cpu")
    injected = lambda step, bs, dev: tuple([torch.from_numpy(np.array(m)).long() for m in ms]
                                           for ms in jmasks)
    port_step = build_train_step(enc, pred, TrainCfg(**TRAIN),
                                 *schedulers.build_schedules(**SCHED),
                                 [masks.MaskSpec.from_cfg(m) for m in MASKS],
                                 masks.MaskGrid(**GRID), keep, mask_sampler=injected)
    spies = {n: mock.patch.object(fa, n, wraps=getattr(fa, n)) for n in _SPIED}
    for s in spies.values():
        s.start()
    try:
        state, metrics = port_step(state, {"clips": torch.from_numpy(clips)})
        calls = {n: getattr(fa, n).call_count for n in _SPIED}
    finally:
        for s in spies.values():
            s.stop()
    # the target's and the context's blocks token-major (the context forward
    # and backward); the predictor's head-major at c=16 (merged backward at
    # 288 tokens) or token-major at c=32
    hm = pred_width == 96
    assert calls == {"flash_self_attention_ref": 2 * DEPTH + (0 if hm else DEPTH),
                     "flash_self_attention_bwd_ref": DEPTH * (1 if hm else 2),
                     "flash_fwd_hm_ref": DEPTH if hm else 0,
                     "flash_bwd_dqkv_hm_ref": DEPTH if hm else 0,
                     "flash_bwd_dq_hm_ref": 0, "flash_bwd_dkv_hm_ref": 0}, calls

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
