"""The diffusion-mode predictor (``use_mask_tokens=False``) of the port vs
the JAX package on the CPU.

``jax.random``'s bits cannot be drawn in torch, so the JAX draws of the
step t and the noise n (``_diffusion_noise``'s key split) are handed to
the port (``noise=`` of the predictor, ``noise_sampler`` of the step);
the port's own draws are checked for their law. JAX runs first in each
test, torch after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.models import predictor as jax_predictor
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.models import predictor as port_predictor
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.predictor import (
    DIFFUSION_STEPS,
    Predictor,
    _diffusion_noise,
    diffusion_draws,
    predictor_forward,
)
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.train.step import TrainCfg, build_train_step, init_train_state, step_generator
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import (
    encoder_state_from_jax,
    predictor_state_from_jax,
    train_state_from_jax,
)
from tests.test_torch_train import B, GEO, SCHED, TRAIN, UPDATE_MASKS

NOISE_TOL = 1e-6
FORWARD_TOL = 2e-4
UPDATE_TOL = 5e-5


def jax_draws(key, shape):
    """The (t, n) ``jepa_tpu.models.predictor._diffusion_noise`` draws from
    ``key`` for features of ``shape``."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (shape[0],), 0, DIFFUSION_STEPS)
    n = jax.random.normal(k_n, shape, dtype=jnp.float32)
    return np.asarray(t), np.asarray(n)


def _as_torch(draws):
    return torch.from_numpy(draws[0].astype(np.int64)), torch.from_numpy(draws[1].copy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(512, 2, 16), (4, 5, 40)])
def test_diffusion_noise_matches_jax(seed, shape):
    x = np.random.default_rng(seed).normal(2.0, 3.0, size=shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_predictor._diffusion_noise(key, jnp.asarray(x)))
    draws = jax_draws(key, shape)
    if shape[0] == 512:  # alpha_t < 0.5^(t+1): small steps carry the signal
        assert (draws[0] < 8).sum() >= 2
    got = _diffusion_noise(torch.from_numpy(x), *_as_torch(draws))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NOISE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_diffusion_noise_formula(dtype):
    """Every step 0..7 (where the signal is not yet gone) against the
    formula in float64: LN without affine (eps 1e-5), then the alpha mix;
    the result in x's dtype."""
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, size=(8, 3, 24)).astype(np.float32)
    t = np.arange(8)
    n = rng.normal(size=x.shape).astype(np.float32)
    got = _diffusion_noise(torch.from_numpy(x).to(dtype), torch.from_numpy(t),
                           torch.from_numpy(n))
    assert got.dtype == dtype
    xf = torch.from_numpy(x).to(dtype).double().numpy()
    xf = (xf - xf.mean(-1, keepdims=True)) / np.sqrt(xf.var(-1, keepdims=True) + 1e-5)
    alphas = np.cumprod(1.0 - (0.5 + np.arange(DIFFUSION_STEPS) * 0.5 / DIFFUSION_STEPS))
    a = alphas[t][:, None, None]
    ref = np.sqrt(a) * xf + np.sqrt(1 - a) * n
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=NOISE_TOL)
    else:  # one bf16 rounding of the fp32 result
        assert np.all(np.abs(got.double().numpy() - ref) <= 2.0 ** -8 * np.abs(ref) + NOISE_TOL)


def test_diffusion_draws_law():
    """The port's own draws: t uniform over [0, 1000), n standard normal,
    the same for one seed."""
    gen = lambda: step_generator(9, 3, torch.device("cpu"))
    t, n = diffusion_draws(gen(), (4096, 4, 32), "cpu")
    t2, n2 = diffusion_draws(gen(), (4096, 4, 32), "cpu")
    assert torch.equal(t, t2) and torch.equal(n, n2)
    assert t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) < DIFFUSION_STEPS
    assert int(t.min()) < 10 and int(t.max()) > 990
    assert abs(t.double().mean().item() - 499.5) < 15  # sd of the mean ~4.5
    assert n.dtype == torch.float32
    assert abs(n.mean().item()) < 0.01 and abs(n.std().item() - 1) < 0.01


GEO_P = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2, uniform_power=True)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_diffusion_predictor_forward_matches_jax(attn_impl):
    jenc = JaxViTCfg(**GEO_P, embed_dim=64, depth=1, num_heads=4, compute_dtype=jnp.float32,
                     attn_impl="xla")
    jcfg = jax_predictor_cfg_for(jenc, predictor_embed_dim=32, depth=2, use_mask_tokens=False)
    params, consts = jax_predictor.init_predictor(jax.random.PRNGKey(4), jcfg)
    assert "mask_tokens" not in params
    rng = np.random.default_rng(4)
    ctxt = rng.normal(size=(2, 11, 64)).astype(np.float32)
    tgt = rng.normal(size=(2, 14, 64)).astype(np.float32)
    perm = [rng.permutation(32) for _ in range(2)]
    mc = np.stack([np.sort(p[:11]) for p in perm]).astype(np.int32)
    mt = np.stack([np.sort(p[11:25]) for p in perm]).astype(np.int32)
    key = jax.random.PRNGKey(21)
    want = np.asarray(jax_predictor.predictor_forward(
        params, consts, jnp.asarray(ctxt), jnp.asarray(tgt), jnp.asarray(mc), jnp.asarray(mt),
        jcfg, mask_index=1, rng=key))
    draws = jax_draws(key, (2, 14, 32))

    enc = ViTCfg(**GEO_P, embed_dim=64, depth=1, num_heads=4, compute_dtype=torch.float32,
                 attn_impl=attn_impl)
    cfg = predictor_cfg_for(enc, predictor_embed_dim=32, depth=2, use_mask_tokens=False)
    model = Predictor(cfg)
    assert len(model.mask_tokens) == 0
    model.load_state_dict(predictor_state_from_jax(jax.tree.map(np.asarray, params),
                                                   jax.tree.map(np.asarray, consts), cfg),
                          strict=True)
    t = lambda a: torch.from_numpy(a)
    with torch.no_grad():
        got = predictor_forward(model, t(ctxt), t(mc).long(), t(mt).long(), mask_index=1,
                                tgt=t(tgt), noise=_as_torch(draws))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_TOL)
    with pytest.raises(ValueError, match="tgt and noise"):
        predictor_forward(model, t(ctxt), t(mc).long(), t(mt).long())


def test_diffusion_update_matches_jax():
    """One fixed-mask update in diffusion mode against
    jepa_tpu.train.step.build_train_step, with the JAX step's masks and
    noise draws handed in (fp32; tolerances of tests/test_torch_train.py)."""
    jenc = JaxViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                     compute_dtype=jnp.float32, attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=32, depth=2, use_mask_tokens=False)
    jstate, jconsts = jax_step.init_train_state(jax.random.PRNGKey(11), jenc, jpred)
    specs = [jax_masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = jax_masks.MaskGrid(t=2, h=4, w=4)
    keep = [jax_masks.calibrate_keep_counts(s, grid, B) for s in specs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, jconsts, tc,
                                        *jax_sched.build_schedules(**SCHED), specs, grid, keep)
    clips = np.random.default_rng(12).normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), jstate["step"], B, specs, grid, keep)
    key = jax.random.fold_in(jax.random.PRNGKey(tc.seed + 2), 0)
    draws = [jax_draws(key, (B, kp, 32)) for _, kp in keep]
    new, metrics = jax.jit(step_fn)(jstate, {"clips": jnp.asarray(clips)})
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    jstate, jconsts, new = to_np(jstate), to_np(jconsts), to_np(new)
    want = {k: float(v) for k, v in metrics.items()}

    enc = ViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                 compute_dtype=torch.float32, attn_impl="xla")
    pred = predictor_cfg_for(enc, predictor_embed_dim=32, depth=2, use_mask_tokens=False)
    state = train_state_from_jax(jstate, jconsts, enc, pred, device="cpu")
    pspecs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    injected_masks = lambda step, bs, dev: tuple(
        [torch.from_numpy(np.array(m)).long() for m in ms] for ms in (me, mp))
    asked = []

    def injected_noise(step, i, shape, dev):
        asked.append((step, i, shape))
        return _as_torch(draws[i])

    step_fn = build_train_step(enc, pred, TrainCfg(**TRAIN),
                               *schedulers.build_schedules(**SCHED), pspecs,
                               masks.MaskGrid(t=2, h=4, w=4), keep,
                               mask_sampler=injected_masks, noise_sampler=injected_noise)
    state, got = step_fn(state, {"clips": torch.from_numpy(clips)})

    assert asked == [(0, i, (B, kp, 32)) for i, (_, kp) in enumerate(keep)]
    np.testing.assert_allclose(got["loss"].item(), want["loss"], rtol=2e-4)
    for k in ("enc_grad_norm", "pred_grad_norm", "pred_qkv_max"):
        np.testing.assert_allclose(got[k].item(), want[k], rtol=2e-4, err_msg=k)
    checks = [(state.encoder, encoder_state_from_jax(new["params"]["encoder"],
                                                     jconsts["encoder"], enc)),
              (state.predictor, predictor_state_from_jax(new["params"]["predictor"],
                                                         jconsts["predictor"], pred)),
              (state.target, encoder_state_from_jax(new["target"], jconsts["encoder"], enc))]
    for module, want_sd in checks:
        got_sd = module.state_dict()
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=UPDATE_TOL, err_msg=k)


def test_default_noise_is_one_generator_per_config(monkeypatch):
    """Without a noise_sampler the step draws each mask config's (t, n)
    from a fresh generator seeded with (seed + 2, step), as the JAX step
    folds one key for every config; a second run repeats the update."""
    enc = ViTCfg(**GEO, embed_dim=32, depth=1, num_heads=2, compute_dtype=torch.float32)
    pred = predictor_cfg_for(enc, predictor_embed_dim=16, depth=1, use_mask_tokens=False)
    specs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    keep = [masks.calibrate_keep_counts(s, grid, B) for s in specs]
    clips = torch.from_numpy(np.random.default_rng(0).normal(size=(B, 4, 32, 32, 3))
                             .astype(np.float32))
    seen = []

    def spy(x, t, n):
        seen.append((t.clone(), n.clone()))
        return _diffusion_noise(x, t, n)

    monkeypatch.setattr(port_predictor, "_diffusion_noise", spy)
    losses = []
    for _ in range(2):
        state = init_train_state(enc, pred, torch.Generator().manual_seed(3), device="cpu")
        step_fn = build_train_step(enc, pred, TrainCfg(**TRAIN),
                                   *schedulers.build_schedules(**SCHED), specs, grid, keep)
        state, metrics = step_fn(state, {"clips": clips})
        losses.append(metrics["loss"].item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    (t0, n0), (t1, n1) = seen[:2]
    want = diffusion_draws(step_generator(TRAIN["seed"] + 2, 0, "cpu"), n0.shape, "cpu")
    assert torch.equal(t0, want[0]) and torch.equal(n0, want[1])
    assert torch.equal(t0, t1)  # one seed for every mask config
    assert n1.shape == (B, keep[1][1], 16)
    assert torch.equal(seen[2][0], t0) and torch.equal(seen[3][1], n1)
