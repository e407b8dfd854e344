"""Activation checkpointing in the port (``remat`` of ViTCfg/PredictorCfg,
``transformer.run_blocks``, ``ops.remat``) on the CPU.

One update with remat False, True and 'attn' gives the same bits (loss,
parameters, AdamW moments): the recomputation repeats the forward's ops.
The plain attention forwards counted per update show what each mode
recomputes: 'attn' runs each block's attention forward once (the JAX
policy keeps the flash (o, lse)), True twice for every trainable block;
'attn' also keeps the qkv projection and the fc1 pre-activation, so its
backward recomputes two of a block's four linears. The update with
remat='attn' matches the JAX package's update with remat='attn' within
5e-5 in fp32, and the pretrain app reads meta.remat / meta.pred_remat with
the JAX app's defaults. JAX runs first in each test, torch after.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from unittest import mock

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.apps.vjepa.train import main as train_main
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.models import transformer
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.ops import flash_attention as fa
from jepa_tpu_torch.ops import fused_mlp as fm
from jepa_tpu_torch.train.step import TrainCfg, build_train_step, init_train_state
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import (
    encoder_state_from_jax,
    predictor_state_from_jax,
    train_state_from_jax,
)

B = 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
MASKS = [dict(num_blocks=4, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5]),
         dict(num_blocks=2, spatial_scale=[0.5, 0.5], aspect_ratio=[0.75, 1.5])]
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)
DEPTH = 2  # encoder and predictor blocks


def _specs():
    specs = [masks.MaskSpec.from_cfg(m) for m in MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    return specs, grid, [masks.calibrate_keep_counts(s, grid, B) for s in specs]


def _clips():
    return torch.from_numpy(
        np.random.default_rng(12).normal(size=(B, 4, 32, 32, 3)).astype(np.float32))


def _counting(name):
    """Patch ``fa.<name>`` to count its calls."""
    calls = [0]
    real = getattr(fa, name)

    def spy(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    return mock.patch.object(fa, name, spy), calls


def _linear_calls():
    calls = [0]
    real = transformer.MatmulF32.forward

    def spy(ctx, x, w):
        calls[0] += 1
        return real(ctx, x, w)

    return mock.patch.object(transformer.MatmulF32, "forward", staticmethod(spy)), calls


def _counting_h8():
    """Patch H8's plain version (LinearGelu's forward on the CPU) to count
    its calls."""
    calls = [0]
    real = fm.linear_gelu_z_ref

    def spy(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    return mock.patch.object(fm, "linear_gelu_z_ref", spy), calls


# (compute dtype, encoder width, heads, predictor width, attn_impl, linears
# a block recomputes under 'attn', the encoder's fused_mlp): token-major
# H1/H2 in fp32 and bf16 (the qkv projection kept: out-projection and fc2
# recomputed), the eager route and vit_tiny's heads (3 of 64 and of 32),
# which run head-major through FlashAttentionPackedFn (the JAX package
# names no qkv there: it is recomputed too), and the context encoder's fc1
# through LinearGelu (fused_mlp='force': H8's plain version, its (o, z)
# kept under 'attn')
CASES = {
    "tm_fp32": (torch.float32, 64, 4, 32, "flash", 2, False),
    "tm_bf16": (torch.bfloat16, 64, 4, 32, "flash", 2, False),
    "eager_fp32": (torch.float32, 64, 4, 32, "xla", 3, False),
    "hm_fp32": (torch.float32, 192, 3, 96, "flash", 3, False),
    "force_fp32": (torch.float32, 128, 4, 32, "flash", 2, "force"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_modes_are_bit_equal(case):
    dt, dim, heads, pred_dim, impl, recomputed, fused = CASES[case]
    specs, grid, keep = _specs()
    clips = _clips().to(dt)
    runs = {}
    for remat in (False, True, "attn"):
        enc = ViTCfg(**GEO, embed_dim=dim, depth=DEPTH, num_heads=heads, uniform_power=True,
                     compute_dtype=dt, attn_impl=impl, remat=remat, fused_mlp=fused)
        pred = predictor_cfg_for(enc, predictor_embed_dim=pred_dim, depth=DEPTH)
        assert pred.remat == remat  # the encoder's, as the JAX factory
        state = init_train_state(enc, pred, torch.Generator().manual_seed(3), device="cpu")
        step_fn = build_train_step(enc, pred, TrainCfg(**TRAIN),
                                   *schedulers.build_schedules(**SCHED), specs, grid, keep)
        tm, tm_calls = _counting("flash_self_attention_ref")
        hm, hm_calls = _counting("flash_fwd_hm_ref")
        lin, lin_calls = _linear_calls()
        h8, h8_calls = _counting_h8()
        with tm, hm, lin, h8:
            state, metrics = step_fn(state, {"clips": clips})
        runs[remat] = (state, metrics, tm_calls[0], hm_calls[0], lin_calls[0], h8_calls[0])

    base, m0, tm0, hm0, lin0, h80 = runs[False]
    # trainable attention blocks per update: encoder and predictor, per mask
    trainable = 2 * DEPTH * len(specs)
    # the context encoder's fc1 runs H8 (LinearGelu) in every trainable
    # encoder block under force, and is no MatmulF32 there
    assert h80 == (trainable // 2 if fused else 0)
    enc_linears = 3 if fused else 4
    for remat in (True, "attn"):
        state, metrics, tm, hm, lin, h8 = runs[remat]
        assert metrics["loss"].item() == m0["loss"].item()
        for k, v in m0.items():
            assert torch.equal(torch.as_tensor(metrics[k]), torch.as_tensor(v)), k
        for mod in ("encoder", "predictor", "target"):
            for (n, p), q in zip(getattr(state, mod).named_parameters(),
                                 getattr(base, mod).parameters()):
                assert torch.equal(p, q), f"{remat} {mod}.{n}"
        for n in base.mu:
            assert torch.equal(state.mu[n], base.mu[n]) and torch.equal(state.nu[n], base.nu[n])
        # what the backward recomputed: True every block, 'attn' no attention
        # forward and some of each block's four linears
        if impl == "flash":
            assert tm + hm == tm0 + hm0 + (trainable if remat is True else 0), (remat, tm, hm)
        full = (enc_linears + 4) * trainable // 2
        assert lin == lin0 + (full if remat is True else recomputed * trainable), (remat, lin)
        # H8 again in the recomputation under True only: 'attn' keeps (o, z)
        assert h8 == h80 * (2 if remat is True else 1), (remat, h8, h80)
    if impl == "flash":
        # the grad-free target plus each trainable block once
        assert tm0 + hm0 == DEPTH + trainable
        assert (hm0 > 0) == (case == "hm_fp32")


def test_remat_attn_update_matches_jax():
    """The JAX update with remat='attn' in the encoder and the predictor
    (attn_impl 'xla') against the port's, on the same parameters, clips and
    masks (fp32; the port through the plain versions of H1/H2)."""
    jenc = JaxViTCfg(**GEO, embed_dim=64, depth=DEPTH, num_heads=4, uniform_power=True,
                     compute_dtype=jnp.float32, attn_impl="xla", remat="attn")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=32, depth=DEPTH)
    assert jpred.remat == "attn"
    state, consts = jax_step.init_train_state(jax.random.PRNGKey(11), jenc, jpred)
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in MASKS]
    jgrid = jax_masks.MaskGrid(t=2, h=4, w=4)
    jkeep = [jax_masks.calibrate_keep_counts(s, jgrid, B) for s in jspecs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, consts, tc,
                                        *jax_sched.build_schedules(**SCHED), jspecs, jgrid,
                                        jkeep)
    clips = _clips().numpy()
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), state["step"], B, jspecs,
        jgrid, jkeep)
    new, metrics = jax.jit(step_fn)(state, {"clips": jnp.asarray(clips)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    state, consts, new = to_np(state), to_np(consts), to_np(new)
    want = {k: float(v) for k, v in metrics.items()}
    drawn = ([np.array(m) for m in me], [np.array(m) for m in mp])

    enc = ViTCfg(**GEO, embed_dim=64, depth=DEPTH, num_heads=4, uniform_power=True,
                 compute_dtype=torch.float32, attn_impl="flash", remat="attn")
    pred = predictor_cfg_for(enc, predictor_embed_dim=32, depth=DEPTH)
    specs, grid, keep = _specs()
    assert keep == jkeep
    port = train_state_from_jax(state, consts, enc, pred, device="cpu")
    injected = lambda step, bs, dev: tuple([torch.from_numpy(m).long() for m in ms]
                                           for ms in drawn)
    fn = build_train_step(enc, pred, TrainCfg(**TRAIN), *schedulers.build_schedules(**SCHED),
                          specs, grid, keep, mask_sampler=injected)
    port, got = fn(port, {"clips": torch.from_numpy(clips)})
    for k in ("loss", "enc_grad_norm", "pred_grad_norm", "enc_qkv_first", "pred_qkv_max"):
        np.testing.assert_allclose(got[k].item(), want[k], rtol=2e-4, err_msg=k)
    checks = [(port.encoder, encoder_state_from_jax(new["params"]["encoder"],
                                                    consts["encoder"], enc)),
              (port.predictor, predictor_state_from_jax(new["params"]["predictor"],
                                                        consts["predictor"], pred)),
              (port.target, encoder_state_from_jax(new["target"], consts["encoder"], enc))]
    for module, want_sd in checks:
        got_sd = module.state_dict()
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)


_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "pretrain_smoke.yaml")


@pytest.mark.parametrize("meta, want", [
    ({}, ("attn", "attn")),                                  # the JAX app's defaults
    ({"remat": False}, (False, False)),
    ({"remat": True}, (True, "attn")),
    ({"pred_remat": False}, ("attn", False)),
])
def test_app_reads_meta_remat(tmp_path, meta, want):
    with open(_FIXTURE) as f:
        cfg = yaml.safe_load(f)
    cfg["logging"]["folder"] = str(tmp_path)
    cfg["meta"].update(meta)
    cfg["optimization"].update(epochs=1, ipe=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = train_main(copy.deepcopy(cfg), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert state.step == 1
    assert (state.encoder.cfg.remat, state.predictor.cfg.remat) == want
