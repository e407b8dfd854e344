"""The port's padded mask mode vs the JAX package on the CPU.

  * host masks: ``MaskCollator`` (chunks, ``set_step``), ``pad_masks``,
    the pad-cap ladders and tiers give the JAX package's integers;
  * padded equals truncated: encoder + predictor + loss with padded masks,
    key masks and validity weights equal the truncated masks in the loss
    and every gradient (tests/test_model_parity.py's property, fp32);
  * one padded update of the port against
    ``jepa_tpu.train.step.build_train_step(mask_mode='padded')`` on the same
    state (``train_state_from_jax``) and batch, on the XLA and flash paths.
Inputs come from numpy with a seed; JAX runs first in each test, torch
after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.masks import padding as jax_padding
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.masks import padding
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.predictor import init_predictor, predictor_forward
from jepa_tpu_torch.models.vit import ViTCfg, init_vit, vit_forward
from jepa_tpu_torch.ops.masking import gather_tokens
from jepa_tpu_torch.train import losses
from jepa_tpu_torch.train.step import TrainCfg, build_train_step
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


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for g_spec, w_spec in zip(got, want):
        assert len(g_spec) == len(w_spec)
        for g, w in zip(g_spec, w_spec):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_collator_chunks_match_jax(n_chunks):
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in VITL16_MASKS]
    jcoll = jax_masks.MaskCollator(jspecs, jax_masks.MaskGrid(**VITL16_GRID), seed=9)
    jcoll.set_step(5)
    want = [jcoll.collate_chunks(4, n_chunks) for _ in range(2)]
    want_plain = jcoll(4)

    specs = [masks.MaskSpec.from_cfg(m) for m in VITL16_MASKS]
    coll = masks.MaskCollator(specs, masks.MaskGrid(**VITL16_GRID), seed=9)
    coll.set_step(5)
    for w in want:
        got = coll.collate_chunks(4, n_chunks)
        _assert_chunks_equal(got[0], w[0])
        _assert_chunks_equal(got[1], w[1])
    _assert_chunks_equal(coll(4), want_plain)


def test_pad_ladders_and_tiers_match_jax():
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in VITL16_MASKS]
    jgrid = jax_masks.MaskGrid(**VITL16_GRID)
    kw = dict(iters=40)
    want = dict(
        ladders=jax_masks.calibrate_pad_ladders(jspecs, jgrid, 8, **kw),
        ladders_chunks=jax_masks.calibrate_pad_ladders(jspecs, jgrid, 8, n_chunks=2, **kw),
        tiers=jax_masks.calibrate_pad_tiers(jspecs, jgrid, 8, **kw),
        tiers_field=jax_masks.calibrate_pad_tiers(jspecs, jgrid, 8, mode="field", **kw),
        caps=[jax_masks.calibrate_pad_caps(s, jgrid, 8, iters=10) for s in jspecs],
    )
    me, mp = jax_masks.MaskCollator(jspecs, jgrid, seed=1).collate_chunks(8, 2)
    want["rungs"] = jax_masks.select_pad_rungs(want["ladders"], me, mp)
    want["tier"] = jax_masks.select_pad_tier(want["tiers"], me, mp)

    specs = [masks.MaskSpec.from_cfg(m) for m in VITL16_MASKS]
    grid = masks.MaskGrid(**VITL16_GRID)
    got = dict(
        ladders=masks.calibrate_pad_ladders(specs, grid, 8, **kw),
        ladders_chunks=masks.calibrate_pad_ladders(specs, grid, 8, n_chunks=2, **kw),
        tiers=masks.calibrate_pad_tiers(specs, grid, 8, **kw),
        tiers_field=masks.calibrate_pad_tiers(specs, grid, 8, mode="field", **kw),
        caps=[masks.calibrate_pad_caps(s, grid, 8, iters=10) for s in specs],
    )
    me, mp = masks.MaskCollator(specs, grid, seed=1).collate_chunks(8, 2)
    got["rungs"] = masks.select_pad_rungs(got["ladders"], me, mp)
    got["tier"] = masks.select_pad_tier(got["tiers"], me, mp)
    assert got == want
    assert all(len(rungs) >= 2 for rungs in got["ladders"])


def test_pad_masks_match_jax():
    idx = np.random.default_rng(0).integers(0, 50, size=(3, 9)).astype(np.int32)
    for cap in (6, 9, 16):
        want = jax_padding.pad_masks(idx, cap)
        got = padding.pad_masks(idx, cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for n, frac in ((1568, 0.3), (1568, 0.99), (100, 0.5)):
        assert padding.static_cap(n, frac) == jax_padding.static_cap(n, frac)


# ---- the model and one update -----------------------------------------------

B = 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
TINY_MASKS = [dict(num_blocks=4, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5]),
              dict(num_blocks=2, spatial_scale=[0.5, 0.5], aspect_ratio=[0.75, 1.5])]
TINY_GRID = dict(t=2, h=4, w=4)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_padded_equals_truncated(attn_impl):
    """Pads (index 0, weight 0, masked as keys) leave the loss and every
    gradient as the truncated masks give them; fp32, <= 1e-5."""
    enc_cfg = ViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                     compute_dtype=torch.float32, attn_impl=attn_impl)
    pred_cfg = predictor_cfg_for(enc_cfg, predictor_embed_dim=32, depth=2)
    gen = torch.Generator().manual_seed(4)
    enc, pred = init_vit(enc_cfg, gen), init_predictor(pred_cfg, gen)
    with torch.no_grad():  # non-zero mask tokens, so the pads carry values
        for mt in pred.mask_tokens:
            mt.normal_(generator=gen)
    rng = np.random.default_rng(5)
    clips = torch.from_numpy(rng.normal(size=(B, 4, 32, 32, 3)).astype(np.float32))
    idx_c = np.stack([np.sort(rng.choice(32, 12, replace=False)) for _ in range(B)])
    idx_p = np.stack([np.setdiff1d(np.arange(32), c) for c in idx_c])
    with torch.no_grad():
        h = losses.layer_norm_targets(vit_forward(enc, clips))

    def loss_and_grads(me, mp, we=None, wp=None):
        t = lambda a: torch.from_numpy(np.asarray(a))
        me, mp = t(me).long(), t(mp).long()
        kv_e = None if we is None else t(we) > 0.5
        kv_p = None if wp is None else t(wp) > 0.5
        wts = None if wp is None else [t(wp)]
        enc.zero_grad(set_to_none=True)
        pred.zero_grad(set_to_none=True)
        z = vit_forward(enc, clips, masks=me, kv_mask=kv_e)
        p = predictor_forward(pred, z, me, mp, kv_mask_ctxt=kv_e, kv_mask_tgt=kv_p)
        loss = (losses.jepa_loss([p], [gather_tokens(h, mp)], 1.0, wts)
                + 0.5 * losses.variance_reg([p], wts))
        loss.backward()
        grads = {f"{m}.{n}": q.grad.clone() for m, mod in (("enc", enc), ("pred", pred))
                 for n, q in mod.named_parameters() if q.grad is not None}
        return loss.item(), grads

    want_loss, want = loss_and_grads(idx_c, idx_p)
    me, we = padding.pad_masks(idx_c, 15)
    mp, wp = padding.pad_masks(idx_p, 24)
    got_loss, got = loss_and_grads(me, mp, we, wp)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=1e-5)
    assert set(got) == set(want) and len(want) > 30
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.1, clip_grad=0.05, clip_after_step=0,
             mask_mode="padded", seed=7)


# (encoder width, heads, predictor width): narrow, and ViT-L's head dims
# (encoder c=64, predictor c=24 padded to 32: H1-fp32 / H2-fp32 at c=64
# and 32, masked, on the card), ViT-H's (c=80) and vit_giant's (c=88
# padded to 96)
WIDTHS = {"narrow": (64, 4, 32), "vitl_heads": (256, 4, 96), "vith_heads": (320, 4, 96),
          "giant_heads": (352, 4, 96)}


def _jax_padded_update(geo):
    """The JAX package's padded-mode update (attn_impl='xla', fp32) on
    seeded weights with the host collator's masks, padded past their K."""
    dim, heads, pred_dim = WIDTHS[geo]
    jenc = JaxViTCfg(**GEO, embed_dim=dim, depth=2, num_heads=heads, uniform_power=True,
                     compute_dtype=jnp.float32, attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=pred_dim, depth=2)
    state, consts = jax_step.init_train_state(jax.random.PRNGKey(13), jenc, jpred)
    specs = [jax_masks.MaskSpec.from_cfg(m) for m in TINY_MASKS]
    grid = jax_masks.MaskGrid(**TINY_GRID)
    keep = [jax_masks.calibrate_keep_counts(s, grid, B) for s in specs]
    me_list, mp_list = jax_masks.MaskCollator(specs, grid, seed=7).collate_chunks(B, 1)
    batch = {k: [] for k in ("masks_enc", "enc_weights", "masks_pred", "pred_weights")}
    for (me,), (mp,) in zip(me_list, mp_list):
        for m, keys in ((me, ("masks_enc", "enc_weights")), (mp, ("masks_pred", "pred_weights"))):
            idx, w = jax_padding.pad_masks(m, m.shape[1] + 3)
            batch[keys[0]].append(idx)
            batch[keys[1]].append(w)
    clips = np.random.default_rng(14).normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, consts, tc,
                                        *jax_sched.build_schedules(**SCHED), specs, grid, keep)
    jbatch = {k: [jnp.asarray(a) for a in v] for k, v in batch.items()}
    new_state, metrics = jax.jit(step_fn)(state, {"clips": jnp.asarray(clips), **jbatch})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(state=to_np(state), consts=to_np(consts), new=to_np(new_state),
                metrics={k: float(v) for k, v in metrics.items()}, clips=clips,
                batch=batch, keep=keep)


@pytest.fixture(scope="module")
def jax_padded_update():
    return _jax_padded_update("narrow")


@pytest.fixture(scope="module")
def jax_padded_update_vitl_heads():
    return _jax_padded_update("vitl_heads")


@pytest.fixture(scope="module")
def jax_padded_update_vith_heads():
    return _jax_padded_update("vith_heads")


@pytest.fixture(scope="module")
def jax_padded_update_giant_heads():
    return _jax_padded_update("giant_heads")


@pytest.mark.parametrize("attn_impl,geo", [("xla", "narrow"), ("flash", "narrow"),
                                           ("flash", "vitl_heads"), ("flash", "vith_heads"),
                                           ("flash", "giant_heads")],
                         ids=["xla", "flash", "flash-vitl-heads", "flash-vith-heads",
                              "flash-giant-heads"])
def test_one_padded_update_matches_jax(request, attn_impl, geo):
    """The port's padded-mode update against the JAX package's on the same
    state, clips and padded masks (the fixed-mode update's tolerances: loss rtol 2e-4,
    parameters and target atol 5e-5, fp32); ``vitl_heads`` at ViT-L's head
    dims, the key-masked plain versions of H1-fp32 / H2-fp32 at c=64 and 32;
    ``vith_heads`` and ``giant_heads`` at c=80 and c=88 padded to 96."""
    ju = request.getfixturevalue("jax_padded_update" if geo == "narrow"
                                 else f"jax_padded_update_{geo}")
    dim, heads, pred_dim = WIDTHS[geo]
    enc = ViTCfg(**GEO, embed_dim=dim, depth=2, num_heads=heads, uniform_power=True,
                 compute_dtype=torch.float32, attn_impl=attn_impl)
    pred = predictor_cfg_for(enc, predictor_embed_dim=pred_dim, depth=2)
    state = train_state_from_jax(ju["state"], ju["consts"], enc, pred, device="cpu")
    specs = [masks.MaskSpec.from_cfg(m) for m in TINY_MASKS]
    grid = masks.MaskGrid(**TINY_GRID)
    step_fn = build_train_step(enc, pred, TrainCfg(**TRAIN),
                               *schedulers.build_schedules(**SCHED), specs, grid, ju["keep"])
    batch = {k: [torch.from_numpy(a) for a in v] for k, v in ju["batch"].items()}
    state, metrics = step_fn(state, {"clips": torch.from_numpy(ju["clips"]), **batch})

    want = ju["metrics"]
    assert set(metrics) == set(want)
    for k in ("loss", "loss_jepa", "loss_reg", "enc_grad_norm", "pred_grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=2e-4, err_msg=k)
    assert state.step == 1 and int(ju["new"]["step"]) == 1
    new, consts = ju["new"], ju["consts"]
    checks = [(state.encoder, encoder_state_from_jax(new["params"]["encoder"],
                                                     consts["encoder"], enc)),
              (state.predictor, predictor_state_from_jax(new["params"]["predictor"],
                                                         consts["predictor"], pred)),
              (state.target, encoder_state_from_jax(new["target"], consts["encoder"], enc))]
    for module, want_sd in checks:
        got_sd = module.state_dict()
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)
