"""Port pretraining update (jepa_tpu_torch.train, masks, schedulers) vs the
JAX package on the CPU.

Each piece (keep counts, losses, AdamW, clipping, EMA, schedules) is held
against its JAX function, and one whole update of the port against
jepa_tpu.train.step.build_train_step on the same parameters (carried over
with train_state_from_jax), clips and JAX-sampled masks, fp32. Inputs come
from numpy with a seed; JAX runs first in each test, torch after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.ops import masking as jax_masking
from jepa_tpu.train import losses as jax_losses
from jepa_tpu.train import optimizer as jax_opt
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.ops.masking import masked_mean, repeat_interleave_batch
from jepa_tpu_torch.train import losses, optimizer
from jepa_tpu_torch.train.step import TrainCfg, build_train_step, init_train_state
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import (
    encoder_state_from_jax,
    predictor_state_from_jax,
    train_state_from_jax,
)

# the two mask configs of configs/pretrain/vitl16.yaml
VITL16_MASKS = [
    dict(num_blocks=8, spatial_scale=[0.15, 0.15], temporal_scale=[1.0, 1.0],
         aspect_ratio=[0.75, 1.5], max_temporal_keep=1.0, max_keep=None),
    dict(num_blocks=2, spatial_scale=[0.7, 0.7], temporal_scale=[1.0, 1.0],
         aspect_ratio=[0.75, 1.5], max_temporal_keep=1.0, max_keep=None),
]
VITL16_GRID = dict(t=8, h=14, w=14)


@pytest.mark.parametrize("which", [0, 1])
def test_calibrate_keep_counts_matches_jax(which):
    want_spec = jax_masks.MaskSpec.from_cfg(VITL16_MASKS[which])
    want_grid = jax_masks.MaskGrid(**VITL16_GRID)
    want = jax_masks.calibrate_keep_counts(want_spec, want_grid, 8)
    want_analytic = jax_masks.resolve_keep_counts(want_spec, want_grid)

    spec = masks.MaskSpec.from_cfg(VITL16_MASKS[which])
    grid = masks.MaskGrid(**VITL16_GRID)
    assert masks.calibrate_keep_counts(spec, grid, 8) == want
    assert want == [(421, 809), (135, 1126)][which]  # the slice's shapes
    assert masks.resolve_keep_counts(spec, grid) == want_analytic
    e, p = masks.HostMaskGenerator(spec, grid, seed=5)(4)
    we, wp = jax_masks.HostMaskGenerator(want_spec, want_grid, seed=5)(4)
    np.testing.assert_array_equal(e, we)
    np.testing.assert_array_equal(p, wp)


@pytest.mark.parametrize("which", [0, 1])
def test_sampler_invariants(which):
    spec = masks.MaskSpec.from_cfg(dict(VITL16_MASKS[which], max_temporal_keep=0.5))
    grid = masks.MaskGrid(**VITL16_GRID)
    ke, kp = masks.calibrate_keep_counts(spec, grid, 4)
    gen = torch.Generator().manual_seed(which)
    (me,), (mp,) = masks.sample_masks_for_specs(gen, 4, [spec], grid, [(ke, kp)])
    assert me.shape == (4, ke) and mp.shape == (4, kp)
    late = set(range(4 * 14 * 14, grid.n))  # frames past max_temporal_keep
    for e, p in zip(me.tolist(), mp.tolist()):
        assert e == sorted(e) and p == sorted(p)
        assert len(set(e)) == ke and len(set(p)) == kp
        assert not set(e) & set(p)          # context from the complement
        assert late <= set(p)               # late frames always predicted
        assert 0 <= min(e + p) and max(e + p) < grid.n
    again = masks.sample_masks_for_specs(torch.Generator().manual_seed(which), 4,
                                         [spec], grid, [(ke, kp)])
    assert torch.equal(again[0][0], me)     # a pure function of the seed


def test_masking_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 3)).astype(np.float32)
    w = (rng.random((6, 5)) > 0.3).astype(np.float32)
    want_rep = np.asarray(jax_masking.repeat_interleave_batch(jnp.asarray(x), 3, 2))
    want_mean = float(jax_masking.masked_mean(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(
        repeat_interleave_batch(torch.from_numpy(x), 3, 2).numpy(), want_rep)
    got = masked_mean(torch.from_numpy(x), torch.from_numpy(w)).item()
    np.testing.assert_allclose(got, want_mean, rtol=1e-6)


@pytest.mark.parametrize("loss_exp", [1.0, 2.0])
def test_losses_match_jax(loss_exp):
    rng = np.random.default_rng(1)
    preds = [rng.normal(size=(2, 7, 16)).astype(np.float32) for _ in range(2)]
    tgts = [rng.normal(size=(2, 7, 16)).astype(np.float32) for _ in range(2)]
    wts = [(rng.random((2, 7)) > 0.2).astype(np.float32) for _ in range(2)]
    j = lambda xs: [jnp.asarray(a) for a in xs]
    want = [float(jax_losses.jepa_loss(j(preds), j(tgts), loss_exp)),
            float(jax_losses.jepa_loss(j(preds), j(tgts), loss_exp, j(wts))),
            float(jax_losses.variance_reg(j(preds))),
            float(jax_losses.variance_reg(j(preds), j(wts)))]
    want_ln = np.asarray(jax_losses.layer_norm_targets(jnp.asarray(preds[0])))

    t = lambda xs: [torch.from_numpy(a) for a in xs]
    got = [losses.jepa_loss(t(preds), t(tgts), loss_exp).item(),
           losses.jepa_loss(t(preds), t(tgts), loss_exp, t(wts)).item(),
           losses.variance_reg(t(preds)).item(),
           losses.variance_reg(t(preds), t(wts)).item()]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        losses.layer_norm_targets(torch.from_numpy(preds[0])).numpy(), want_ln, atol=1e-6)


def _tree(rng):
    """A small two-module parameter tree with the JAX package's leaf names."""
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"encoder": {"patch_embed": {"w": leaf(6, 4), "b": leaf(4)},
                        "norm": {"scale": leaf(4), "bias": leaf(4)}},
            "predictor": {"mask_tokens": leaf(2, 4),
                          "predictor_proj": {"w": leaf(4, 3), "b": leaf(3)}}}


def _flat(tree):
    """The tree's leaves in JAX order, named like the port's parameters."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(".".join(str(k.key) for k in path), leaf) for path, leaf in leaves]


@pytest.mark.parametrize("step", [1, 7])
def test_adamw_matches_jax(step):
    rng = np.random.default_rng(step)
    params, grads, mu = _tree(rng), _tree(rng), _tree(rng)
    nu = jax.tree.map(np.abs, _tree(rng))
    lr, wd = np.float32(3e-3), np.float32(0.3)
    jt = lambda t: jax.tree.map(jnp.asarray, t)
    want_p, want_opt, want_stats = jax_opt.adamw_update(
        jt(params), jt(grads), {"mu": jt(mu), "nu": jt(nu)}, lr=lr, wd=wd,
        mask=jax_opt.decay_mask(jt(params)), step=step)

    names = [n for n, _ in _flat(params)]
    dm = [float(m) for _, m in _flat(jax_opt.decay_mask(params))]
    tt = lambda t: [torch.from_numpy(np.array(a)) for _, a in _flat(t)]
    p, g, m, v = tt(params), tt(grads), tt(mu), tt(nu)
    stats = optimizer.adamw_update_(p, g, m, v, dm, names, lr=float(lr), wd=float(wd),
                                    step=step)
    for got, want in ((p, want_p), (m, want_opt["mu"]), (v, want_opt["nu"])):
        for a, (_, b) in zip(got, _flat(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    for k in ("exp_avg_abs_mean", "exp_avg_sq_mean"):
        np.testing.assert_allclose(stats[k].item(), float(want_stats[k]), rtol=1e-6)


_JAX_TO_PORT_LEAF = {
    "predictor_embed.w": "predictor_embed.weight", "predictor_embed.b": "predictor_embed.bias",
    "norm.scale": "predictor_norm.weight", "norm.bias": "predictor_norm.bias",
    "predictor_proj.w": "predictor_proj.weight", "predictor_proj.b": "predictor_proj.bias",
    "mask_tokens": "mask_tokens",
    **{f"blocks.{a}.{b}": f"predictor_blocks.{c}" for a, b, c in [
        ("ln1", "scale", "norm1.weight"), ("ln1", "bias", "norm1.bias"),
        ("ln2", "scale", "norm2.weight"), ("ln2", "bias", "norm2.bias"),
        ("attn", "qkv_w", "attn.qkv.weight"), ("attn", "qkv_b", "attn.qkv.bias"),
        ("attn", "proj_w", "attn.proj.weight"), ("attn", "proj_b", "attn.proj.bias"),
        ("mlp", "fc1_w", "mlp.fc1.weight"), ("mlp", "fc1_b", "mlp.fc1.bias"),
        ("mlp", "fc2_w", "mlp.fc2.weight"), ("mlp", "fc2_b", "mlp.fc2.bias")]},
}


def test_decay_mask_rule_matches_jax():
    """Biases and LayerNorm parameters are not decayed, everything else
    (mask tokens included) is: leaf by leaf the JAX rule on the predictor."""
    from jepa_tpu.models.predictor import init_predictor as jax_init_predictor
    from jepa_tpu_torch.models.predictor import Predictor

    jcfg = jax_predictor_cfg_for(JaxViTCfg(embed_dim=32, depth=1, num_heads=2, img_size=32,
                                           patch_size=16, num_frames=4),
                                 predictor_embed_dim=16, depth=2)
    jparams, _ = jax_init_predictor(jax.random.PRNGKey(0), jcfg)
    want = {_JAX_TO_PORT_LEAF[n]: float(m) for n, m in _flat(jax_opt.decay_mask(jparams))}

    cfg = predictor_cfg_for(ViTCfg(embed_dim=32, depth=1, num_heads=2, img_size=32,
                                   patch_size=16, num_frames=4),
                            predictor_embed_dim=16, depth=2)
    got = optimizer.decay_mask(Predictor(cfg))
    assert len(want) == 19 and sum(want.values()) == 7
    assert {optimizer._leaf_kind(n): m for n, m in got.items()} == want
    assert len(got) == 6 + 2 * 12 + 2  # per-layer blocks, two mask tokens


@pytest.mark.parametrize("enabled", [False, True])
def test_clip_and_ema_match_jax(enabled):
    rng = np.random.default_rng(3)
    grads = _tree(rng)["encoder"]
    target, online = _tree(rng)["encoder"], _tree(rng)["encoder"]
    jt = lambda t: jax.tree.map(jnp.asarray, t)
    want_g, want_n = jax_opt.clip_by_global_norm(jt(grads), 1.5, jnp.asarray(enabled))
    want_t = jax_opt.ema_update(jt(target), jt(online), jnp.float32(0.99))

    g = [torch.from_numpy(np.array(a)) for _, a in _flat(grads)]
    norm = optimizer.clip_by_global_norm(g, 1.5, enabled)
    np.testing.assert_allclose(norm.item(), float(want_n), rtol=1e-6)
    for a, (_, b) in zip(g, _flat(want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    t = [torch.from_numpy(np.array(a)) for _, a in _flat(target)]
    optimizer.ema_update_(t, [torch.from_numpy(np.array(a)) for _, a in _flat(online)], 0.99)
    for a, (_, b) in zip(t, _flat(want_t)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_schedules_match_jax():
    kw = dict(ipe=300, num_epochs=300, warmup_epochs=40, start_lr=2e-4, ref_lr=6.25e-4,
              final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.998, 1.0), ipe_scale=1.25)
    steps = [0, 1, 2, 11999, 12000, 12001, 60000, 112499, 112500, 200000]
    want = [[float(s(i)) for i in steps] for s in jax_sched.build_schedules(**kw)]
    got = [[s(i).item() for i in steps] for s in schedulers.build_schedules(**kw)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert schedulers.WarmupCosine(10, 0.1, 1.0, 100)(5).dtype == torch.float32


# ---- one whole update ------------------------------------------------------

B = 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
UPDATE_MASKS = [dict(num_blocks=4, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5]),
                dict(num_blocks=2, spatial_scale=[0.5, 0.5], aspect_ratio=[0.75, 1.5])]
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)


@pytest.fixture(scope="module")
def jax_update():
    """The JAX package's update (attn_impl='xla', fp32) on seeded weights,
    with the masks its step samples, as numpy."""
    jenc = JaxViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                     compute_dtype=jnp.float32, attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=32, depth=2)
    state, consts = jax_step.init_train_state(jax.random.PRNGKey(11), jenc, jpred)
    specs = [jax_masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = jax_masks.MaskGrid(t=2, h=4, w=4)
    keep = [jax_masks.calibrate_keep_counts(s, grid, B) for s in specs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    scheds = jax_sched.build_schedules(**SCHED)
    step_fn = jax_step.build_train_step(jenc, jpred, consts, tc, *scheds, specs, grid, keep)
    clips = np.random.default_rng(12).normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), state["step"], B, specs,
        grid, keep)
    new_state, metrics = jax.jit(step_fn)(state, {"clips": jnp.asarray(clips)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(state=to_np(state), consts=to_np(consts), new=to_np(new_state),
                metrics={k: float(v) for k, v in metrics.items()}, clips=clips,
                masks=([np.asarray(m) for m in me], [np.asarray(m) for m in mp]),
                keep=keep, jpred=jpred)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_one_update_matches_jax(jax_update, attn_impl):
    """attn_impl='flash' puts FlashSelfAttentionFn and the plain versions of
    H1/H2 (with the predictor's head dim 8 zero-padded to 32) inside the
    port's step; the JAX side runs its XLA attention. Tolerances of
    tests/test_train_parity.py."""
    ju = jax_update
    enc = ViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                 compute_dtype=torch.float32, attn_impl=attn_impl)
    pred = predictor_cfg_for(enc, predictor_embed_dim=32, depth=2)
    state = train_state_from_jax(ju["state"], ju["consts"], enc, pred, device="cpu")
    specs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    keep = [masks.calibrate_keep_counts(s, grid, B) for s in specs]
    assert keep == ju["keep"]
    injected = lambda step, bs, dev: tuple([torch.from_numpy(np.array(m)).long() for m in ms]
                                           for ms in ju["masks"])
    step_fn = build_train_step(enc, pred, TrainCfg(**TRAIN),
                               *schedulers.build_schedules(**SCHED), specs, grid, keep,
                               mask_sampler=injected)
    state, metrics = step_fn(state, {"clips": torch.from_numpy(ju["clips"])})

    want = ju["metrics"]
    assert set(metrics) == set(want)
    np.testing.assert_allclose(metrics["loss"].item(), want["loss"], rtol=2e-4)
    for k in ("enc_grad_norm", "pred_grad_norm", "enc_qkv_first", "pred_qkv_max"):
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=2e-4, err_msg=k)
    for k in ("lr", "wd", "ema_momentum", "input_var", "input_var_min"):
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=1e-6, err_msg=k)
    assert state.step == 1 and int(ju["new"]["step"]) == 1
    new = ju["new"]
    checks = [(state.encoder, encoder_state_from_jax(new["params"]["encoder"],
                                                     ju["consts"]["encoder"], enc)),
              (state.predictor, predictor_state_from_jax(new["params"]["predictor"],
                                                         ju["consts"]["predictor"], pred)),
              (state.target, encoder_state_from_jax(new["target"],
                                                    ju["consts"]["encoder"], enc))]
    for module, want_sd in checks:
        got_sd = module.state_dict()
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)


def test_num_clips_tiles_the_masks():
    """num_clips=2 on two identical copies of the clips (clip-major, as
    repeat_interleave_batch tiles the masks) is the num_clips=1 update."""
    enc = ViTCfg(**GEO, embed_dim=32, depth=1, num_heads=2, compute_dtype=torch.float32)
    pred = predictor_cfg_for(enc, predictor_embed_dim=16, depth=1)
    specs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    keep = [masks.calibrate_keep_counts(s, grid, B) for s in specs]
    clips = torch.from_numpy(np.random.default_rng(0).normal(size=(B, 4, 32, 32, 3)).astype(np.float32))
    out = []
    for n, batch in ((1, clips), (2, torch.cat([clips, clips]))):
        state = init_train_state(enc, pred, torch.Generator().manual_seed(3), device="cpu")
        step_fn = build_train_step(enc, pred, TrainCfg(**dict(TRAIN, num_clips=n)),
                                   *schedulers.build_schedules(**SCHED), specs, grid, keep)
        state, metrics = step_fn(state, {"clips": batch})
        out.append((metrics["loss"].item(), state.encoder.blocks[0].attn.qkv.weight.detach()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(), atol=1e-6)


def test_non_fixed_mask_mode_raises():
    """Fixed and padded are ported; the tube mode raises."""
    enc = ViTCfg(**GEO, embed_dim=32, depth=1, num_heads=2)
    with pytest.raises(NotImplementedError, match="tube"):
        build_train_step(enc, predictor_cfg_for(enc), TrainCfg(mask_mode="tube"),
                         *schedulers.build_schedules(**SCHED), [], None, [])
