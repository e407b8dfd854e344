"""Pos-embed resizing for off-size inputs (jepa_tpu_torch.models.pos_embed,
models.vit._pos_embed_for_input) vs the JAX package on the CPU.

The tables resize as ``jax.image.resize`` does (antialiased
scale_and_translate, Keys cubic a = -0.5, renormalised edge weights), up
and down: the port's weight matrices are bit-equal to JAX's
``compute_weight_mat``, its tables within 1e-6 of ``scale_and_translate``
run op by op, which is ``jax.image.resize``'s definition. The jitted
``jax.image.resize`` (the JAX package's ``resize_pos_embed_*``) builds the
weights in a fused XLA CPU program, up to 1.43e-6 from the same formula
evaluated op by op, so the tables are held against it within 4e-6
(measured 3.04e-6). The encoder forwards at off-size video and image
inputs match ``jepa_tpu.models.vit.vit_forward``. JAX runs first in each
test, torch after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, _fill_triangle_kernel, compute_weight_mat

from jepa_tpu.models import pos_embed as jax_pos_embed
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.models.vit import init_vit as jax_init_vit
from jepa_tpu.models.vit import vit_forward as jax_vit_forward
from jepa_tpu_torch.models import pos_embed
from jepa_tpu_torch.models.vit import VisionTransformer, vit_forward
from jepa_tpu_torch.utils.checkpoint_port import encoder_state_from_jax
from tests.test_torch_models import _port_cfg

TABLE_TOL = 1e-6      # against scale_and_translate, op by op
JIT_TABLE_TOL = 4e-6  # against the jitted jax.image.resize (XLA's fused weights)
FORWARD_TOL = 2e-4

# (src, dst) token grids: the 224 px, 16-frame model's (8, 14, 14) at 32
# frames of 256 px (up), 8 frames of 160 px (down), and mixed directions
GRIDS = [((8, 14, 14), (16, 16, 16)), ((8, 14, 14), (4, 10, 10)),
         ((8, 14, 14), (8, 20, 9)), ((2, 4, 4), (5, 3, 7)),
         ((14, 14), (16, 16)), ((14, 14), (10, 10)), ((14, 14), (12, 20)), ((4, 4), (3, 9))]
_JAX_KERNELS = {"linear": _fill_triangle_kernel, "cubic": _fill_keys_cubic_kernel}


def _table(src, dim, kind):
    """A sincos table, or a random one in [-1, 1] (a sincos table's range)."""
    if kind == "random":
        rng = np.random.default_rng(sum(src))
        return rng.uniform(-1, 1, size=(int(np.prod(src)), dim)).astype(np.float32)
    if len(src) == 3:
        return jax_pos_embed.get_3d_sincos_pos_embed(dim, src[1], src[0],
                                                     uniform_power=True).astype(np.float32)
    return jax_pos_embed.get_2d_sincos_pos_embed(dim, src[0]).astype(np.float32)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("n_in,n_out", [(14, 16), (14, 10), (14, 20), (14, 12), (8, 4),
                                        (8, 16), (3, 7), (5, 5)])
def test_resize_weights_equal_jax(n_in, n_out, method):
    want = np.asarray(compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in),
                                         jnp.float32(0.0), _JAX_KERNELS[method], True)).T
    got = pos_embed.resize_weights(n_in, n_out, method)
    assert got.shape == (n_out, n_in) and not got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("src,dst", GRIDS)
@pytest.mark.parametrize("kind", ["sincos", "random"])
def test_resize_pos_embed_matches_jax(src, dst, kind):
    dim = 48 if len(src) == 3 else 32
    pe = _table(src, dim, kind)
    video = len(src) == 3
    method = "linear" if video else "cubic"
    dims = tuple(i for i in range(len(src)) if src[i] != dst[i])
    want = np.asarray(jax.image.scale_and_translate(
        jnp.asarray(pe.reshape(*src, dim)), (*dst, dim), dims,
        jnp.asarray([dst[i] / src[i] for i in dims], jnp.float32),
        jnp.zeros(len(dims), jnp.float32), method, antialias=True)).reshape(-1, dim)
    jax_resize = jax_pos_embed.resize_pos_embed_3d if video else jax_pos_embed.resize_pos_embed_2d
    want_jit = np.asarray(jax_resize(jnp.asarray(pe), src, dst))

    resize = pos_embed.resize_pos_embed_3d if video else pos_embed.resize_pos_embed_2d
    got = resize(torch.from_numpy(pe), src, dst)
    assert got.dtype == torch.float32 and got.shape == (int(np.prod(dst)), dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TABLE_TOL)
    np.testing.assert_allclose(got.numpy(), want_jit, rtol=0, atol=JIT_TABLE_TOL)


def test_resize_same_grid_is_identity():
    pe = torch.from_numpy(_table((4, 9), 8, "random"))
    assert pos_embed.resize_pos_embed_2d(pe, (4, 9), (4, 9)) is pe
    assert pos_embed.resize_pos_embed_3d(pe, (1, 4, 9), (1, 4, 9)) is pe


# (model geometry, input shape): off-size video (more frames and pixels,
# fewer frames and pixels) and image inputs
OFF_SIZE = [
    (dict(img_size=32, num_frames=4), (2, 8, 48, 40, 3)),
    (dict(img_size=32, num_frames=4), (2, 2, 24, 24, 3)),
    (dict(img_size=32, num_frames=1), (2, 48, 24, 3)),
    (dict(img_size=32, num_frames=1), (2, 16, 16, 3)),
]


@pytest.mark.parametrize("geo,shape", OFF_SIZE)
def test_off_size_encoder_forward_matches_jax(geo, shape):
    jcfg = JaxViTCfg(**geo, patch_size=8, tubelet_size=2, embed_dim=64, depth=2, num_heads=4,
                     uniform_power=True, compute_dtype=jnp.float32, attn_impl="xla")
    params, consts = jax_init_vit(jax.random.PRNGKey(5), jcfg)
    x = np.random.default_rng(len(shape) + shape[1]).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_vit_forward(params, consts, jnp.asarray(x), jcfg))

    cfg = _port_cfg(jcfg)
    model = VisionTransformer(cfg)
    model.load_state_dict(encoder_state_from_jax(jax.tree.map(np.asarray, params),
                                                 jax.tree.map(np.asarray, consts), cfg))
    with torch.no_grad():
        got = vit_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[1] != cfg.num_patches
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL)
