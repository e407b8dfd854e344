"""Frozen sin-cos position embeddings, 1D / 2D / 3D (counterpart of
jepa_tpu/models/pos_embed.py, rewritten here in numpy).

  * 1D: emb(p) = [sin(p*w_0..w_{D/2-1}), cos(...)], w_j = 1/10000^(j/(D/2)).
  * 2D: [height | width] halves over a row-major (h, w) grid.
  * 3D: [depth | height | width] over a row-major (d, h, w) grid, widths
    (D/2, D/4, D/4), or ceil(D/6)*2 each under ``uniform_power``, then
    truncated to D.

``resize_pos_embed_3d`` (trilinear) and ``resize_pos_embed_2d`` (cubic)
resize a table to an off-size input grid as ``jax.image.resize`` does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] float64 sin-cos embedding."""
    if embed_dim % 2:
        raise ValueError("sin-cos embedding dim must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size, embed_dim]; row p embeds position p."""
    return sincos_1d(embed_dim, np.arange(grid_size, dtype=np.float64))


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """[grid_size**2, embed_dim]; rows indexed (h, w) row-major."""
    grid = np.arange(grid_size, dtype=np.float64)
    ww, hh = np.meshgrid(grid, grid)
    return np.concatenate(
        [sincos_1d(embed_dim // 2, hh), sincos_1d(embed_dim // 2, ww)], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int, grid_size: int, grid_depth: int, uniform_power: bool = False
) -> np.ndarray:
    """[grid_depth*grid_size**2, embed_dim]; rows indexed (d, h, w) row-major."""
    d = np.arange(grid_depth, dtype=np.float64)
    hw = np.arange(grid_size, dtype=np.float64)
    dd, hh, ww = np.meshgrid(d, hw, hw, indexing="ij")
    if uniform_power:
        d_dim = h_dim = w_dim = int(math.ceil(embed_dim / 6) * 2)
    else:
        d_dim = embed_dim // 2
        h_dim = w_dim = embed_dim // 4
    pos = np.concatenate(
        [sincos_1d(d_dim, dd), sincos_1d(h_dim, hh), sincos_1d(w_dim, ww)], axis=1)
    return pos[:, :embed_dim]


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(x.dtype.type(0), 1 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (torch's bicubic uses
    -0.75)."""
    f = x.dtype.type
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2, f(0.0), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_out, n_in] resampling matrix of one axis, as ``jax.image.resize``
    builds it (``scale_and_translate`` with antialias=True: half-pixel
    centres; when downsampling the kernel widens by n_in / n_out; each
    output's weights are renormalised to sum to 1, or zeroed where they sum
    to almost nothing), in fp32 arithmetic as JAX computes it, returned as
    float64. Read-only (cached)."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)  # [n_in, n_out]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T, dtype=np.float64)
    w.flags.writeable = False
    return w


def _resize_grid(pos: torch.Tensor, src_grid, dst_grid, method: str) -> torch.Tensor:
    """[prod(src_grid), D] -> [prod(dst_grid), D], one resampling matrix
    per axis whose size changes, applied in float64 on ``pos``'s device."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos
    grid = pos.reshape(*src_grid, pos.shape[-1]).double()
    for axis, (n_in, n_out) in enumerate(zip(src_grid, dst_grid)):
        if n_in != n_out:
            w = torch.from_numpy(resize_weights(n_in, n_out, method).copy()).to(grid.device)
            grid = torch.movedim(torch.tensordot(w, grid, dims=([1], [axis])), 0, axis)
    return grid.reshape(-1, pos.shape[-1]).to(pos.dtype)


def resize_pos_embed_3d(pos: torch.Tensor, src_grid, dst_grid) -> torch.Tensor:
    """Trilinear resize of a (t, h, w)-grid table [N_src, D] for off-size
    inputs (jepa_tpu/models/pos_embed.py::resize_pos_embed_3d,
    ``jax.image.resize(..., "trilinear")``; reference
    src/models/vision_transformer.py:197-246)."""
    return _resize_grid(pos, src_grid, dst_grid, "linear")


def resize_pos_embed_2d(pos: torch.Tensor, src_grid, dst_grid) -> torch.Tensor:
    """Cubic resize of an (h, w)-grid table [N_src, D]
    (``jax.image.resize(..., "cubic")``)."""
    return _resize_grid(pos, src_grid, dst_grid, "cubic")
