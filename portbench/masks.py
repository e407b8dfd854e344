"""Multiblock-3D masks of the pretraining cells, made by the benchmark and
handed to the program and the reference alike.

``keep_counts`` is a copy of jepa_tpu_torch/masks/multiblock3d.py's
``calibrate_keep_counts`` (itself the JAX package's): the fixed (K_enc,
K_pred) of a mask config, the means of the reference distribution's
batch-min sizes over 25 draws at the per-card batch. ``sample_fixed`` is a
numpy copy of that module's torch fixed-K sampler: the block geometry shared
by the batch, per-sample placements, exactly K_pred targets chosen by
priority (frames past ``max_temporal_keep`` > block union > random fill),
K_enc context tokens from the rest, indices sorted.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    """One entry of a pretraining YAML's ``mask:`` list."""

    aspect_ratio: Tuple[float, float]
    num_blocks: int
    spatial_scale: Tuple[float, float]
    temporal_scale: Tuple[float, float]
    max_temporal_keep: float = 1.0
    max_keep: Optional[int] = None

    @staticmethod
    def from_dict(m: dict) -> "Spec":
        return Spec(aspect_ratio=tuple(m["aspect_ratio"]), num_blocks=int(m["num_blocks"]),
                    spatial_scale=tuple(m["spatial_scale"]),
                    temporal_scale=tuple(m["temporal_scale"]),
                    max_temporal_keep=float(m.get("max_temporal_keep", 1.0)),
                    max_keep=m.get("max_keep"))


@dataclasses.dataclass(frozen=True)
class Grid:
    """Token grid (T, H, W)."""

    t: int
    h: int
    w: int

    @property
    def n(self) -> int:
        return self.t * self.h * self.w


def _ctx_dur(spec: Spec, grid: Grid) -> int:
    return max(1, int(grid.t * spec.max_temporal_keep))


def _host_block_size(rng: np.random.Generator, spec: Spec, grid: Grid):
    t_scale = spec.temporal_scale[0] + rng.random() * (spec.temporal_scale[1] - spec.temporal_scale[0])
    t = max(1, int(grid.t * t_scale))
    s_scale = spec.spatial_scale[0] + rng.random() * (spec.spatial_scale[1] - spec.spatial_scale[0])
    num_keep = int(grid.h * grid.w * s_scale)
    ar = spec.aspect_ratio[0] + rng.random() * (spec.aspect_ratio[1] - spec.aspect_ratio[0])
    h = min(int(round(math.sqrt(num_keep * ar))), grid.h)
    w = min(int(round(math.sqrt(num_keep / ar))), grid.w)
    return t, max(1, h), max(1, w)


def _reference_draw(spec: Spec, grid: Grid, batch_size: int, seed: int, it: int):
    """Batch-min (K_enc, K_pred) of one draw of the reference distribution."""
    bt, bh, bw = _host_block_size(np.random.default_rng((seed, it)), spec, grid)
    rng = np.random.default_rng((seed, it, 1))
    ctx_dur = _ctx_dur(spec, grid)
    min_enc, min_pred = grid.n, grid.n
    for _ in range(batch_size):
        while True:
            keep = np.ones((grid.t, grid.h, grid.w), dtype=bool)
            for _ in range(spec.num_blocks):
                top = rng.integers(0, grid.h - bh + 1)
                left = rng.integers(0, grid.w - bw + 1)
                start = rng.integers(0, grid.t - bt + 1)
                keep[start:start + bt, top:top + bh, left:left + bw] = False
            if ctx_dur < grid.t:
                keep[ctx_dur:] = False
            n_enc = int(keep.sum())
            if n_enc:
                break
        min_enc = min(min_enc, n_enc)
        min_pred = min(min_pred, grid.n - n_enc)
    if spec.max_keep is not None:
        min_enc = min(min_enc, int(spec.max_keep))
    return min_enc, min_pred


def keep_counts(spec: Spec, grid: Grid, batch_size: int, iters: int = 25,
                seed: int = 1234) -> Tuple[int, int]:
    """(K_enc, K_pred) of the fixed mask mode at ``batch_size``."""
    sizes = [_reference_draw(spec, grid, batch_size, seed, it) for it in range(iters)]
    k_enc = max(1, min(int(round(float(np.mean([s[0] for s in sizes])))), grid.n - 1))
    k_pred = max(1, min(int(round(float(np.mean([s[1] for s in sizes])))), grid.n - 1))
    if spec.max_keep is not None:
        k_enc = min(k_enc, int(spec.max_keep))
    return k_enc, k_pred


def _block_size(rng: np.random.Generator, spec: Spec, grid: Grid):
    r = rng.random(3, dtype=np.float32)
    t = max(1, int(np.float32(grid.t) * (spec.temporal_scale[0] + r[0]
                                         * (spec.temporal_scale[1] - spec.temporal_scale[0]))))
    num_keep = grid.h * grid.w * (spec.spatial_scale[0] + r[1]
                                  * (spec.spatial_scale[1] - spec.spatial_scale[0]))
    ar = spec.aspect_ratio[0] + r[2] * (spec.aspect_ratio[1] - spec.aspect_ratio[0])
    h = int(np.clip(np.round(np.sqrt(num_keep * ar)), 1, grid.h))
    w = int(np.clip(np.round(np.sqrt(num_keep / ar)), 1, grid.w))
    return t, h, w


def sample_fixed(rng: np.random.Generator, batch_size: int, spec: Spec, grid: Grid,
                 k_enc: int, k_pred: int) -> Tuple[np.ndarray, np.ndarray]:
    """([B, K_enc], [B, K_pred]) int64 sorted token indices, disjoint in
    every sample."""
    bt, bh, bw = _block_size(rng, spec, grid)
    u = rng.random((batch_size, spec.num_blocks, 3))
    top = np.floor(u[..., 0] * (grid.h + 1 - bh)).astype(np.int64)[..., None, None, None]
    left = np.floor(u[..., 1] * (grid.w + 1 - bw)).astype(np.int64)[..., None, None, None]
    start = np.floor(u[..., 2] * (grid.t + 1 - bt)).astype(np.int64)[..., None, None, None]
    tt = np.arange(grid.t)[:, None, None]
    hh = np.arange(grid.h)[None, :, None]
    ww = np.arange(grid.w)[None, None, :]
    blocks = ((tt >= start) & (tt < start + bt) & (hh >= top) & (hh < top + bh)
              & (ww >= left) & (ww < left + bw))            # [B, nb, T, H, W]
    late = np.broadcast_to(tt >= _ctx_dur(spec, grid), (grid.t, grid.h, grid.w))
    union = (blocks.any(axis=1) | late).reshape(batch_size, grid.n)
    noise = rng.random((batch_size, grid.n))
    score = 2.0 * late.reshape(1, grid.n) + union + noise
    pred = np.argsort(-score, axis=1, kind="stable")[:, :k_pred]
    in_pred = np.zeros((batch_size, grid.n), dtype=bool)
    np.put_along_axis(in_pred, pred, True, axis=1)
    enc = np.argsort(-(2.0 * ~in_pred + noise), axis=1, kind="stable")[:, :k_enc]
    return np.sort(enc, axis=1), np.sort(pred, axis=1)


def sample_step(rng: np.random.Generator, batch_size: int, specs: Sequence[Spec], grid: Grid,
                keep: Sequence[Tuple[int, int]]) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Every mask config of one update, drawn in order."""
    enc, pred = [], []
    for spec, (ke, kp) in zip(specs, keep):
        e, p = sample_fixed(rng, batch_size, spec, grid, ke, kp)
        enc.append(e)
        pred.append(p)
    return enc, pred
