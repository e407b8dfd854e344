"""Frozen sin-cos position embeddings, 1D / 2D / 3D (counterpart of
jepa_tpu/models/pos_embed.py, rewritten here in numpy).

  * 1D: emb(p) = [sin(p*w_0..w_{D/2-1}), cos(...)], w_j = 1/10000^(j/(D/2)).
  * 2D: [height | width] halves over a row-major (h, w) grid.
  * 3D: [depth | height | width] over a row-major (d, h, w) grid, widths
    (D/2, D/4, D/4), or ceil(D/6)*2 each under ``uniform_power``, then
    truncated to D.

Resizing a table to an off-size input grid is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np


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
