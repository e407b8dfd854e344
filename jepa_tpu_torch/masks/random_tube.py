"""Random-tube masking, VideoMAE style: one random spatial keep-set per
sample, tiled across every time step (counterpart of
jepa_tpu/masks/random_tube.py; reference src/masks/random_tube.py:96-106).

Two parts:

  * numpy, copied from the JAX package so that both give the same
    integers: ``TubeSpec``, ``keep_counts`` and the host collator of the
    padded mode, ``TubeMaskCollator``, with its chunk-keyed streams
    ``(seed, counter, spec[, chunk])`` and ``collate_chunks``;
  * torch, the sampler of the train step: ``sample_tube_masks`` draws on
    the generator's device from an explicit ``torch.Generator``, one
    ``randperm`` per sample, in sample order. The train step seeds one
    generator per step (``train.step.step_generator(seed, step)``) and
    draws the mask configs from it in order, as the JAX step folds the
    step and then the config index into its key; the bits differ from
    ``jax.random``'s, so parity tests inject the JAX package's masks.

The masks are exact-K by construction (int(H*W*(1 - ratio)) spatial
positions kept), so the fixed mode needs no calibration and no key mask.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from jepa_tpu_torch.masks.multiblock3d import MaskGrid


@dataclasses.dataclass(frozen=True)
class TubeSpec:
    ratio: float = 0.9

    @staticmethod
    def from_cfg(m: dict) -> "TubeSpec":
        return TubeSpec(ratio=float(m.get("ratio", 0.9)))


def _keep_spatial(spec: TubeSpec, grid: MaskGrid) -> int:
    return int(grid.h * grid.w * (1.0 - spec.ratio))


def keep_counts(spec: TubeSpec, grid: MaskGrid) -> Tuple[int, int]:
    """(K_enc, K_pred): the kept spatial positions times the time steps,
    and the rest of the grid."""
    k_enc = _keep_spatial(spec, grid) * grid.t
    return k_enc, grid.n - k_enc


def sample_tube_masks(generator: torch.Generator, batch_size: int, spec: TubeSpec,
                      grid: MaskGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B, K_enc], [B, K_pred]) int64 token indices on the generator's
    device, each row sorted ascending: a random permutation of the spatial
    positions split at the keep count, each part sorted and tiled across
    the ``grid.t`` time steps."""
    dev = generator.device
    n_spatial = grid.h * grid.w
    keep = _keep_spatial(spec, grid)
    perms = torch.stack([torch.randperm(n_spatial, generator=generator, device=dev)
                         for _ in range(batch_size)])
    t_off = (torch.arange(grid.t, device=dev) * n_spatial)[None, :, None]
    tile = lambda s: (s.sort(dim=1).values[:, None, :] + t_off).reshape(batch_size, -1)
    return tile(perms[:, :keep]), tile(perms[:, keep:])


class TubeMaskCollator:
    """Host collator of the padded mode (the multiblock collator's
    counter-step protocol): per mask config, [B, K_enc] and [B, K_pred]
    int32 arrays drawn from ``np.random.default_rng((seed, counter, i))``,
    chunk c > 0 from ``(seed, counter, i, c)``."""

    def __init__(self, specs: Sequence[TubeSpec], grid: MaskGrid, seed: int = 0):
        self.specs = list(specs)
        self.grid = grid
        self.seed = seed
        self._counter = -1

    def step(self):
        self._counter += 1

    def set_step(self, step: int):
        """O(1) resume: the next collate draws step ``step``."""
        self._counter = step - 1

    def _chunk(self, batch_size: int, chunk: int):
        out_e, out_p = [], []
        g = self.grid
        n_spatial = g.h * g.w
        for i, spec in enumerate(self.specs):
            key = ((self.seed, self._counter, i) if chunk == 0
                   else (self.seed, self._counter, i, chunk))
            rng = np.random.default_rng(key)
            keep_spatial = _keep_spatial(spec, g)
            encs, preds = [], []
            for _ in range(batch_size):
                perm = rng.permutation(n_spatial)
                keep = np.sort(perm[:keep_spatial])
                drop = np.sort(perm[keep_spatial:])
                t_off = (np.arange(g.t) * n_spatial)[:, None]
                encs.append((keep[None] + t_off).reshape(-1))
                preds.append((drop[None] + t_off).reshape(-1))
            out_e.append(np.stack(encs).astype(np.int32))
            out_p.append(np.stack(preds).astype(np.int32))
        return out_e, out_p

    def __call__(self, batch_size: int):
        self.step()
        return self._chunk(batch_size, 0)

    def collate_chunks(self, batch_size: int, n_chunks: int):
        """``n_chunks`` per-device collates on one counter step: per mask
        config a list of [batch_size, K] chunks (one shape: exact-K)."""
        self.step()
        chunks = [self._chunk(batch_size, c) for c in range(n_chunks)]
        out_e = [[ch[0][s] for ch in chunks] for s in range(len(self.specs))]
        out_p = [[ch[1][s] for ch in chunks] for s in range(len(self.specs))]
        return out_e, out_p
