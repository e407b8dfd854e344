"""The port's tube mask mode (jepa_tpu_torch.masks.random_tube and
``mask_mode='tube'``) vs the JAX package on the CPU.

The host collator of the padded mode gives the JAX collator's integers
over several seeds, steps and chunks; the keep counts are equal; the
torch sampler keeps its invariants (sorted, disjoint, covering, the same
spatial set in every time step); one tube update of the port matches
jepa_tpu.train.step.build_train_step(mask_mode='tube') on the same
parameters, clips and JAX-sampled masks (handed in through
``mask_sampler``) within 5e-5 in fp32. JAX runs first in each test, torch
after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_mb
from jepa_tpu.masks import random_tube as jax_tube
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import random_tube as tube
from jepa_tpu_torch.masks.multiblock3d import MaskGrid
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.train.step import TrainCfg, build_train_step
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import encoder_state_from_jax, train_state_from_jax

VITL16_GRID = dict(t=8, h=14, w=14)


@pytest.mark.parametrize("ratio", [0.9, 0.75, 0.5])
def test_keep_counts_match_jax(ratio):
    want = jax_tube.keep_counts(jax_tube.TubeSpec(ratio), jax_mb.MaskGrid(**VITL16_GRID))
    got = tube.keep_counts(tube.TubeSpec.from_cfg({"ratio": ratio}), MaskGrid(**VITL16_GRID))
    assert got == want
    if ratio == 0.9:  # ViT-L at 16x224: 19 of 196 positions, 8 time steps
        assert got == (152, 1416)


@pytest.mark.parametrize("seed", [0, 7, 234])
def test_collator_is_bit_equal_to_jax(seed):
    """Calls, a resume by set_step, and per-device chunks: the same int32
    arrays as the JAX collator."""
    grid = dict(t=2, h=6, w=5)
    ratios = (0.9, 0.6)
    jc = jax_tube.TubeMaskCollator([jax_tube.TubeSpec(r) for r in ratios],
                                   jax_mb.MaskGrid(**grid), seed=seed)
    want = [jc(3), jc(3)]
    jc.set_step(11)
    want.append(jc.collate_chunks(2, 3))

    pc = tube.TubeMaskCollator([tube.TubeSpec(r) for r in ratios], MaskGrid(**grid),
                               seed=seed)
    got = [pc(3), pc(3)]
    pc.set_step(11)
    got.append(pc.collate_chunks(2, 3))
    for g, w in zip(got[:2], want[:2]):
        for gs, ws in zip(g, w):  # (masks_enc, masks_pred), per spec
            for a, b in zip(gs, ws):
                assert a.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    for gs, ws in zip(got[2], want[2]):  # per spec, per chunk
        for chunks_g, chunks_w in zip(gs, ws):
            assert len(chunks_g) == 3
            for a, b in zip(chunks_g, chunks_w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ratio", [0.9, 0.5])
def test_sampler_invariants(ratio):
    grid = MaskGrid(**VITL16_GRID)
    spec = tube.TubeSpec(ratio)
    ke, kp = tube.keep_counts(spec, grid)
    me, mp = tube.sample_tube_masks(torch.Generator().manual_seed(3), 4, spec, grid)
    assert me.shape == (4, ke) and mp.shape == (4, kp)
    hw = grid.h * grid.w
    for e, p in zip(me.tolist(), mp.tolist()):
        assert e == sorted(e) and p == sorted(p)
        assert sorted(e + p) == list(range(grid.n))       # disjoint and covering
        spatial = [set(x % hw for x in e if x // hw == t) for t in range(grid.t)]
        assert all(s == spatial[0] for s in spatial)      # one tube through time
        assert len(spatial[0]) == ke // grid.t
    again = tube.sample_tube_masks(torch.Generator().manual_seed(3), 4, spec, grid)
    assert torch.equal(again[0], me) and torch.equal(again[1], mp)
    other = tube.sample_tube_masks(torch.Generator().manual_seed(4), 4, spec, grid)
    assert not torch.equal(other[0], me)
    assert len({tuple(r) for r in me.tolist()}) > 1       # per-sample draws


B = 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
RATIOS = (0.75, 0.5)
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)


def test_tube_update_matches_jax():
    """One update in mask_mode='tube': the JAX step samples its tube masks
    on the device; the port's step takes those masks through
    ``mask_sampler``. fp32, attn_impl 'xla' on the JAX side and 'flash'
    (the plain versions of H1/H2) on the port's."""
    jenc = JaxViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                     compute_dtype=jnp.float32, attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=32, depth=2)
    state, consts = jax_step.init_train_state(jax.random.PRNGKey(5), jenc, jpred)
    jspecs = [jax_tube.TubeSpec(r) for r in RATIOS]
    jgrid = jax_mb.MaskGrid(t=2, h=4, w=4)
    jkeep = [jax_tube.keep_counts(s, jgrid) for s in jspecs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B, mask_mode="tube")
    step_fn = jax_step.build_train_step(jenc, jpred, consts, tc,
                                        *jax_sched.build_schedules(**SCHED), jspecs,
                                        jgrid, jkeep)
    clips = np.random.default_rng(6).normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
    # the JAX step's own draw (jepa_tpu/train/step.py::sample_step_masks)
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), 0)
    drawn = [jax_tube.sample_tube_masks(jax.random.fold_in(rng, i), B, s, jgrid)
             for i, s in enumerate(jspecs)]
    masks = ([np.asarray(m[0]) for m in drawn], [np.asarray(m[1]) for m in drawn])
    new, metrics = jax.jit(step_fn)(state, {"clips": jnp.asarray(clips)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    state, consts, new = to_np(state), to_np(consts), to_np(new)
    want = {k: float(v) for k, v in metrics.items()}

    enc = ViTCfg(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True,
                 compute_dtype=torch.float32, attn_impl="flash")
    pred = predictor_cfg_for(enc, predictor_embed_dim=32, depth=2)
    specs = [tube.TubeSpec(r) for r in RATIOS]
    grid = MaskGrid(t=2, h=4, w=4)
    keep = [tube.keep_counts(s, grid) for s in specs]
    assert keep == jkeep == [(8, 24), (16, 16)]
    port = train_state_from_jax(state, consts, enc, pred, device="cpu")
    injected = lambda step, bs, dev: tuple([torch.from_numpy(np.array(m)).long() for m in ms]
                                           for ms in masks)
    fn = build_train_step(enc, pred, TrainCfg(**TRAIN, mask_mode="tube"),
                          *schedulers.build_schedules(**SCHED), specs, grid, keep,
                          mask_sampler=injected)
    port, got = fn(port, {"clips": torch.from_numpy(clips)})
    for k in ("loss", "enc_grad_norm", "pred_grad_norm", "enc_qkv_first", "pred_qkv_max"):
        np.testing.assert_allclose(got[k].item(), want[k], rtol=2e-4, err_msg=k)
    for module, jtree in ((port.encoder, new["params"]["encoder"]),
                          (port.target, new["target"])):
        want_sd = encoder_state_from_jax(jtree, consts["encoder"], enc)
        for k, v in want_sd.items():
            np.testing.assert_allclose(module.state_dict()[k].numpy(), v.numpy(), atol=5e-5,
                                       err_msg=k)

    # the default sampler: tube masks from (seed, step), the configs in order
    port2 = train_state_from_jax(state, consts, enc, pred, device="cpu")
    fn2 = build_train_step(enc, pred, TrainCfg(**TRAIN, mask_mode="tube"),
                           *schedulers.build_schedules(**SCHED), specs, grid, keep)
    port2, m2 = fn2(port2, {"clips": torch.from_numpy(clips)})
    assert np.isfinite(m2["loss"].item()) and port2.step == 1
