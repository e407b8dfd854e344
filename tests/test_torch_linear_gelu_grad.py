"""The differentiated fused fc1 (jepa_tpu_torch.ops.fused_mlp.LinearGelu and
H8's plain version) vs the JAX package's linear_gelu custom_vjp on the CPU.

Under a gradient JAX's linear_gelu runs K11 (_fwd_kernel_z: z rounded to
the compute dtype, the A&S erf GELU in bf16 as in fp32) and an XLA
backward; the port runs LinearGelu: H8's plain version forward, the same
backward in plain torch. The Pallas kernels run in interpret mode. Inputs
come from numpy with a seed; JAX runs first in each test, torch after.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.transformer import BlockCfg as JaxBlockCfg
from jepa_tpu.models.transformer import init_block_stack
from jepa_tpu.models.transformer import run_blocks as jax_run_blocks
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.ops.fused_mlp import _call, _fwd_kernel_z
from jepa_tpu.ops.fused_mlp import linear_gelu as jax_linear_gelu
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.transformer import Block, BlockCfg, run_blocks
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.ops import fused_mlp as fm
from jepa_tpu_torch.train.step import TrainCfg, build_train_step
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import (
    _block_state,
    encoder_state_from_jax,
    predictor_state_from_jax,
    train_state_from_jax,
)

_DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, k, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, f)) / np.sqrt(k)).astype(np.float32)  # JAX [in, out]
    b = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    dy = rng.normal(size=(m, f)).astype(np.float32)
    return x, w, b, dy


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_vjp(x, w, b, dy, jdt):
    """JAX's linear_gelu under jax.vjp (K11 forward, XLA backward)."""
    o, vjp = jax.vjp(lambda x, w, b: jax_linear_gelu(x, w, b, interpret=True),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(dy, jdt))
    return _f32(o), _f32(dx), _f32(dw), _f32(db)


def _port_grad(x, w, b, dy, tdt):
    """The port's linear_gelu under autograd; w given in JAX's [K, F]."""
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).to(tdt).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    o = fm.linear_gelu(xt, wt, bt)
    o.backward(torch.from_numpy(dy).to(tdt))
    return (o.detach().float().numpy(), xt.grad.float().numpy(),
            wt.grad.float().numpy().T, bt.grad.numpy())


def _assert_flips(got, want):
    """bf16: z rounds to bf16 in both, so a rare flip of that rounding (fp32
    sums in another order) moves a value by up to 1.13 ulp of z on top of
    its own ulp: |d| <= 2^-6 * max(|ref|, 1), on under 1 % of the values
    (tests/test_torch_fused_mlp.py's rule)."""
    d = np.abs(got - want)
    assert (d <= 2.0**-6 * np.maximum(np.abs(want), 1)).all(), d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()


@pytest.mark.parametrize("dtype,m", [pytest.param("fp32", 64, id="fp32"),
                                     pytest.param("bf16", 64, id="bf16"),
                                     pytest.param("fp32", 333, id="fp32-ragged-m")])
def test_linear_gelu_z_ref_matches_k11(dtype, m):
    """(o, z) of H8's plain version against K11 (_fwd_kernel_z) itself; M
    333 leaves the kernels' last 128-row tile partial."""
    jdt, tdt = _DT[dtype]
    x, w, b, _ = _inputs(m, 128, 512, seed=20)
    o_j, z_j = _call(_fwd_kernel_z, jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                     jnp.asarray(b), True, True)
    o_j, z_j = _f32(o_j), _f32(z_j)

    o, z = fm.linear_gelu_z_ref(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w.T.copy()).to(tdt), torch.from_numpy(b))
    assert o.dtype == z.dtype == tdt and o.shape == z.shape == (m, 512)
    for got, want in ((o.float().numpy(), o_j), (z.float().numpy(), z_j)):
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            _assert_flips(got, want)


def test_identity_probe_bf16_is_bit_equal_to_jax():
    """x a bf16 grid over [-6, 6], w = I, b = 0, dy = 1: z = x exactly, so
    o isolates the GELU. Under a gradient JAX's o is K11's A&S erf GELU,
    not the exp2-erfc one of the grad-free kernel: the port's o must be
    bit-equal, and dx (exact dgelu: lax.erf vs torch.erf) within one bf16
    rounding, 2^-8 * max(|ref|, 2^-4)."""
    n = 256
    x = np.linspace(-6.0, 6.0, 64 * n, dtype=np.float32).reshape(64, n)
    w = np.eye(n, dtype=np.float32)
    b = np.zeros(n, np.float32)
    dy = np.ones((64, n), np.float32)
    o_j, dx_j, _, _ = _jax_vjp(x, w, b, dy, jnp.bfloat16)

    o, dx, _, _ = _port_grad(x, w, b, dy, torch.bfloat16)
    np.testing.assert_array_equal(o, o_j)
    assert (np.abs(dx - dx_j) <= 2.0**-8 * np.maximum(np.abs(dx_j), 2.0**-4)).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_linear_gelu_grads_match_jax_vjp(dtype):
    """dx, dw, db against jax.vjp of linear_gelu(interpret=True): fp32 at
    the JAX suite's own 2e-5 (tests/test_fused_mlp.py), bf16 at
    max|d| <= 5e-3 * max|ref| per gradient (rare z and g rounding flips
    summed over M or F)."""
    jdt, tdt = _DT[dtype]
    x, w, b, dy = _inputs(96, 128, 256, seed=21)
    want = _jax_vjp(x, w, b, dy, jdt)

    with mock.patch.object(fm, "linear_gelu_z_ref", wraps=fm.linear_gelu_z_ref) as h8:
        got = _port_grad(x, w, b, dy, tdt)
    assert h8.call_count == 1
    for g, r, name in zip(got, want, ("o", "dx", "dw", "db")):
        assert g.shape == r.shape, name
        if dtype == "fp32":
            np.testing.assert_allclose(g, r, atol=2e-5, rtol=2e-5, err_msg=name)
        elif name == "o":
            _assert_flips(g, r)
        else:
            assert np.abs(g - r).max() <= 5e-3 * np.abs(r).max(), name


def test_grad_free_call_keeps_h3():
    """Without a gradient linear_gelu stays on H3's plain version (bf16:
    the exp2-erfc GELU), as JAX's primal runs K10."""
    x, w, b, _ = _inputs(64, 128, 256, seed=22)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w.T.copy()).bfloat16()
    with mock.patch.object(fm, "linear_gelu_z_ref", wraps=fm.linear_gelu_z_ref) as h8, \
            mock.patch.object(fm, "linear_gelu_ref", wraps=fm.linear_gelu_ref) as h3:
        with torch.no_grad():
            a = fm.linear_gelu(xt, wt, torch.from_numpy(b))
        c = fm.linear_gelu(xt.detach(), wt, torch.from_numpy(b))
    assert (h8.call_count, h3.call_count) == (0, 2)
    assert torch.equal(a, c)


def test_outside_tiling_stays_plain_under_grad():
    """vit_tiny's fc1 (K=192) is outside the kernels' tiling: under a
    gradient both packages take the plain exact-erf path, with the same
    values and gradients."""
    x, w, b, dy = _inputs(16, 192, 768, seed=23)
    want = _jax_vjp(x, w, b, dy, jnp.float32)

    with mock.patch.object(fm.LinearGelu, "apply", wraps=fm.LinearGelu.apply) as fn:
        got = _port_grad(x, w, b, dy, torch.float32)
    assert fn.call_count == 0
    for g, r, name in zip(got, want, ("o", "dx", "dw", "db")):
        np.testing.assert_allclose(g, r, atol=2e-5, rtol=2e-5, err_msg=name)


def test_force_blocks_under_grad_match_jax():
    """Two blocks with fused_mlp='force' differentiated, fp32: the port's
    run_blocks (LinearGelu in both MLPs) against JAX's (K11 + its XLA
    backward), the counterpart of tests/test_fused_mlp.py's block test.
    Output at the model-forward 2e-4 (PARITY.md:11), gradients at that
    test's 5e-4."""
    base = dict(dim=128, num_heads=4, mlp_hidden=512)
    jcfg = JaxBlockCfg(**base, compute_dtype=jnp.float32, attn_impl="xla", fused_mlp="force")
    params = init_block_stack(jax.random.PRNGKey(5), 2, jcfg)
    x = np.random.default_rng(6).normal(size=(2, 80, 128)).astype(np.float32)

    def loss(p, x):
        out, _ = jax_run_blocks(x, p, jcfg)
        return jnp.sum(out**2), out

    (_, out_j), grads_j = jax.value_and_grad(loss, has_aux=True)(params, jnp.asarray(x))
    out_j = np.asarray(out_j)
    grads_j = jax.tree.map(np.asarray, grads_j)
    params = jax.tree.map(np.asarray, params)

    cfg = BlockCfg(**base, compute_dtype=torch.float32, attn_impl="xla", fused_mlp="force")
    blocks = torch.nn.ModuleList(Block(cfg) for _ in range(2))
    blocks.load_state_dict({k: v for i in range(2)
                            for k, v in _block_state(params, i, str(i)).items()})
    with mock.patch.object(fm, "linear_gelu_z_ref", wraps=fm.linear_gelu_z_ref) as h8:
        out, _ = run_blocks(torch.from_numpy(x), blocks, cfg)
        (out**2).sum().backward()
    assert h8.call_count == 2
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=2e-4, rtol=0)
    want = {k: v for i in range(2) for k, v in _block_state(grads_j, i, str(i)).items()}
    for name, p in blocks.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=name)


B = 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
WIDTH = dict(embed_dim=128, depth=2, num_heads=4)  # mlp 512: inside the kernels' tiling
UPDATE_MASKS = [dict(num_blocks=4, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5]),
                dict(num_blocks=2, spatial_scale=[0.5, 0.5], aspect_ratio=[0.75, 1.5])]
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)


def test_force_update_matches_jax():
    """One update with the context encoder's fc1 fused and differentiated
    (enc_cfg fused_mlp='force'), fp32: the port's build_train_step (H8's
    plain version + LinearGelu's backward in every context block; the
    target stays grad-free, eager on the CPU) against the JAX package's
    (K11 in interpret mode + its XLA backward), on the same weights, clips
    and JAX-sampled masks; the update's 5e-5 (ROADMAP, tests/test_torch_train.py)."""
    jenc = JaxViTCfg(**GEO, **WIDTH, uniform_power=True, compute_dtype=jnp.float32,
                     attn_impl="xla", fused_mlp="force")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=64, depth=2)
    jstate, jconsts = jax_step.init_train_state(jax.random.PRNGKey(17), jenc, jpred)
    jspecs = [jax_masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    jgrid = jax_masks.MaskGrid(t=2, h=4, w=4)
    keep = [jax_masks.calibrate_keep_counts(s, jgrid, B) for s in jspecs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=B)
    step_fn = jax_step.build_train_step(jenc, jpred, jconsts, tc,
                                       *jax_sched.build_schedules(**SCHED), jspecs, jgrid, keep)
    clips = np.random.default_rng(18).normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), jstate["step"], B, jspecs, jgrid, keep)
    jnew, jmetrics = jax.jit(step_fn)(jstate, {"clips": jnp.asarray(clips)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    jstate, jconsts, jnew = to_np(jstate), to_np(jconsts), to_np(jnew)
    jmasks = ([np.asarray(m) for m in me], [np.asarray(m) for m in mp])

    enc = ViTCfg(**GEO, **WIDTH, uniform_power=True, compute_dtype=torch.float32,
                 attn_impl="xla", fused_mlp="force")
    pred = predictor_cfg_for(enc, predictor_embed_dim=64, depth=2)
    state = train_state_from_jax(jstate, jconsts, enc, pred, device="cpu")
    specs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    injected = lambda step, bs, dev: tuple([torch.from_numpy(np.array(m)).long() for m in ms]
                                           for ms in jmasks)
    port_step = build_train_step(enc, pred, TrainCfg(**TRAIN),
                                 *schedulers.build_schedules(**SCHED), specs, grid, keep,
                                 mask_sampler=injected)
    with mock.patch.object(fm, "linear_gelu_z_ref", wraps=fm.linear_gelu_z_ref) as h8, \
            mock.patch.object(fm, "linear_gelu_ref", wraps=fm.linear_gelu_ref) as h3:
        state, metrics = port_step(state, {"clips": torch.from_numpy(clips)})
    assert (h8.call_count, h3.call_count) == (WIDTH["depth"] * len(UPDATE_MASKS), 0)

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
