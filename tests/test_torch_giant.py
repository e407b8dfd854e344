"""vit_giant's and vit_gigantic's head geometry through the port vs the JAX
package on the CPU.

vit_giant has 16 heads of 88 and vit_gigantic 16 heads of 104; neither has
a token-major head split at its own head dim, so both packages zero-pad it
to the next multiple of 32 (96 and 128) in the qkv projection and run the
token-major kernels there: K1 and its backward in Pallas interpret mode in
the JAX package, the plain versions of H1 and H2 here (on a CUDA tensor,
H1 / H2 at c=96 and c=128, and H1-fp32 at both in the fp32 evals).

  (a) attention alone: o and the gradients of x, w and b through
      flash_self_attention, with and without a key mask, at N = 40 and 129;
  (b) an encoder forward at each model's width, heads and MLP (depth 2),
      fp32 and bf16, attention and fc1 through the kernels' paths;
  (c) one fixed-mask update at vit_giant's padded route narrowed to 4
      heads of 88 (depth 2, a depth-2 predictor of 4 heads of 24 padded to
      32) against build_train_step.

Weights are carried across with encoder_state_from_jax /
train_state_from_jax; inputs come from numpy with a seed; JAX runs first in
each test, torch after. Tolerances: fp32 attention 3e-5 (PARITY.md:13),
the forward 2e-4 (PARITY.md:11), bf16 per-token cosine > 0.999
(tests/test_torch_models.py), the update 5e-5 (tests/test_torch_train.py).
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
from jepa_tpu.ops.flash_attention import flash_self_attention as jax_flash_self_attention
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
from tests.test_torch_models import _port_cfg
from tests.test_torch_train import B, GEO, SCHED, TRAIN, UPDATE_MASKS

ATTN_TOL = 3e-5  # fp32 attention forward and grads (PARITY.md:13)
# (embed_dim, heads, mlp_ratio) of each model and the head dim it runs at
MODELS = {m: (_SPECS[m][0], _SPECS[m][2], _SPECS[m][3]) for m in ("vit_giant", "vit_gigantic")}
PADDED = {"vit_giant": 96, "vit_gigantic": 128}


def test_giant_geometry_routes():
    """Both models pad to a kernel head dim and take the token-major route
    at their sequence lengths (N = 1568, 2048), as the JAX pickers do."""
    for m, (dim, heads, _) in MODELS.items():
        c = dim // heads
        assert fa.padded_head_dim(c) == PADDED[m]
        assert PADDED[m] in fa.KERNEL_HEAD_DIMS and PADDED[m] in fa.F32_HEAD_DIMS
        for n in (40, 129, 1568, 2048):
            assert fa.self_attention_route(heads, c, n) == "tm"
        fa.check_tma_layout(heads, PADDED[m])


def _key_mask(n):
    m = np.ones((2, n), bool)
    m[0, n // 3:n // 2] = False  # a run of pads mid-sequence
    m[0, n - 5:] = False
    m[1, n - n // 4:] = False    # a ragged tail
    return m


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("n", [40, 129])
@pytest.mark.parametrize("masked", [False, True])
def test_padded_attention_matches_jax(model, n, masked):
    """(a) flash_self_attention at 16 heads of 88 / 104 (pad lanes added to
    the projection, sliced off o) against jax.grad of the JAX package's
    flash_self_attention in interpret mode: o, and the gradient of qkv
    (the projection is the identity, so qkv = x and dx = dqkv)."""
    _, h, _ = MODELS[model]
    c = MODELS[model][0] // h
    rng = np.random.default_rng(n + 7 * masked + c)
    x = rng.normal(size=(2, n, 3 * h * c)).astype(np.float32)  # qkv
    w = np.eye(3 * h * c, dtype=np.float32)
    bias = np.zeros(3 * h * c, np.float32)
    r = rng.normal(size=(2, n, h * c)).astype(np.float32)  # cotangent of o
    mask = _key_mask(n) if masked else None

    def run(x_):
        return jax_flash_self_attention(x_, jnp.asarray(w), jnp.asarray(bias), h, interpret=True,
                                        kv_mask=None if mask is None else jnp.asarray(mask))

    want_o, vjp = jax.vjp(run, jnp.asarray(x))
    want_o, (want,) = np.asarray(want_o), vjp(jnp.asarray(r))

    xt = torch.from_numpy(x).requires_grad_(True)
    with mock.patch.object(fa, "flash_self_attention_ref",
                           wraps=fa.flash_self_attention_ref) as fwd:
        o = fa.flash_self_attention(xt, torch.from_numpy(w), torch.from_numpy(bias), h,
                                    kv_mask=None if mask is None else torch.from_numpy(mask))
    qkv = fwd.call_args[0][0]  # the plain H1 ran at the padded head dim
    assert qkv.shape == (2, n, 3 * h * PADDED[model])
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=ATTN_TOL, rtol=0)
    (o * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=ATTN_TOL, rtol=0, err_msg="dqkv")


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_giant_encoder_matches_jax(model, dtype):
    """(b) A depth-2 encoder at the model's width, heads and MLP ratio (its
    factory patch; 4 frames of 2 x 2 patches: N = 8), attention forced
    through the flash path and the fc1 through the fused one (the JAX
    package's K1 and K10 in interpret mode, the plain versions of H1 and
    H3 here)."""
    dim, heads, ratio = MODELS[model]
    patch = _SPECS[model][4]
    jdt = getattr(jnp, dtype)
    jcfg = JaxViTCfg(embed_dim=dim, depth=2, num_heads=heads, mlp_ratio=ratio,
                     img_size=2 * patch, patch_size=patch, num_frames=4, attn_impl="flash",
                     fused_mlp="force", compute_dtype=jdt)
    params, consts = jax_init_vit(jax.random.PRNGKey(15), jcfg)
    x = np.random.default_rng(15).normal(size=(2, 4, 2 * patch, 2 * patch, 3)).astype(np.float32)
    want = np.asarray(jax_vit_forward(params, consts, jnp.asarray(x, jdt), jcfg))

    cfg = _port_cfg(jcfg)
    model_t = VisionTransformer(cfg)
    model_t.load_state_dict(encoder_state_from_jax(jax.tree.map(np.asarray, params),
                                                   jax.tree.map(np.asarray, consts), cfg),
                            strict=True)
    with mock.patch.object(fa, "flash_self_attention_ref",
                           wraps=fa.flash_self_attention_ref) as fwd, torch.no_grad():
        got = vit_forward(model_t, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert fwd.call_count == 2
    assert fwd.call_args[0][0].shape[-1] == 3 * heads * PADDED[model]
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 8, dim)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)  # PARITY.md:11
    else:
        # bf16 rounds at a few points differently (the softmax shift, fp32
        # sums in another order): hold each token's direction
        cos = torch.nn.functional.cosine_similarity(got, torch.from_numpy(want.copy()), dim=-1)
        assert cos.min().item() > 0.999, cos.min().item()


# (c): vit_giant's head dim and MLP ratio at 4 heads; the update's geometry,
# masks, schedules and loss those of tests/test_torch_train.py
NARROW = dict(embed_dim=4 * 88, num_heads=4, depth=2, mlp_ratio=_SPECS["vit_giant"][3])


def test_giant_padded_update_matches_jax():
    """(c) One fixed-mask update, fp32: 4 heads of 88 (no token-major split
    at 88, one at 96), depth 2, with a 96-wide depth-2 predictor (4 heads
    of 24, padded to 32): the port with attn_impl='flash' (the plain
    versions of H1 / H2 at c=96 for the target and contexts, at c=32 for
    the predictor) against build_train_step with its XLA attention."""
    assert fa.self_attention_route(4, 88, 128) == "tm" and fa.padded_head_dim(88) == 96
    jenc = JaxViTCfg(**GEO, **NARROW, uniform_power=True, compute_dtype=jnp.float32,
                     attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, predictor_embed_dim=96, depth=2)
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

    enc = ViTCfg(**GEO, **NARROW, uniform_power=True, compute_dtype=torch.float32,
                 attn_impl="flash")
    pred = predictor_cfg_for(enc, predictor_embed_dim=96, depth=2)
    state = train_state_from_jax(jstate, jconsts, enc, pred, device="cpu")
    specs = [masks.MaskSpec.from_cfg(m) for m in UPDATE_MASKS]
    grid = masks.MaskGrid(t=2, h=4, w=4)
    injected = lambda step, bs, dev: tuple([torch.from_numpy(np.array(m)).long() for m in ms]
                                           for ms in jmasks)
    port_step = build_train_step(enc, pred, TrainCfg(**TRAIN),
                                 *schedulers.build_schedules(**SCHED), specs, grid, keep,
                                 mask_sampler=injected)
    with mock.patch.object(fa, "flash_self_attention_ref",
                           wraps=fa.flash_self_attention_ref) as fwd, \
            mock.patch.object(fa, "flash_self_attention_bwd_ref",
                              wraps=fa.flash_self_attention_bwd_ref) as bwd:
        state, metrics = port_step(state, {"clips": torch.from_numpy(clips)})
    # the target's blocks forward; per mask config the context's and the
    # predictor's blocks forward and backward
    widths = sorted(call[0][0].shape[-1] for call in fwd.call_args_list)
    assert widths == [3 * 4 * 32] * 4 + [3 * 4 * 96] * 6
    assert bwd.call_count == 2 * (NARROW["depth"] + 2)

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
