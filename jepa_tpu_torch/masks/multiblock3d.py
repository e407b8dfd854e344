"""Multiblock-3D masking (counterpart of jepa_tpu/masks/multiblock3d.py).

Two parts:

  * numpy, copied from the JAX package so that both give the same
    integers: ``MaskSpec``, ``MaskGrid``, ``expected_pred_coverage``,
    ``resolve_keep_counts``, the reference-distribution host generator
    ``HostMaskGenerator`` and ``calibrate_keep_counts``, which sets the
    fixed (K_enc, K_pred) of each mask config from the reference's
    batch-min truncation at the actual batch size; for the padded mode the
    host ``MaskCollator`` (per-device chunks, O(1) resume) and the pad-cap
    calibration ``calibrate_pad_caps`` / ``calibrate_pad_tiers`` /
    ``calibrate_pad_ladders`` with ``select_pad_rungs`` /
    ``select_pad_tier``;
  * torch, the fixed-K sampler of the train step: ``sample_masks`` and
    ``sample_masks_for_specs`` draw on the generator's device from an
    explicit ``torch.Generator``. Block geometry is shared across the
    batch, placements are per sample, exactly K_pred targets are chosen
    by priority (frames past ``max_temporal_keep`` > block union > random
    fill, ties broken by uniform noise), the context is K_enc tokens of
    the complement of the chosen targets, and indices come sorted. The
    bits differ from ``jax.random``'s, so parity tests inject the JAX
    package's masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """One mask config (an entry of the YAML ``mask:`` list)."""

    aspect_ratio: Tuple[float, float] = (0.3, 3.0)
    num_blocks: int = 1
    spatial_scale: Tuple[float, float] = (0.2, 0.8)
    temporal_scale: Tuple[float, float] = (1.0, 1.0)
    max_temporal_keep: float = 1.0
    max_keep: Optional[int] = None

    @staticmethod
    def from_cfg(m: dict) -> "MaskSpec":
        return MaskSpec(
            aspect_ratio=tuple(m.get("aspect_ratio", (0.3, 3.0))),
            num_blocks=int(m.get("num_blocks", 1)),
            spatial_scale=tuple(m.get("spatial_scale", (0.2, 0.8))),
            temporal_scale=tuple(m.get("temporal_scale", (1.0, 1.0))),
            max_temporal_keep=float(m.get("max_temporal_keep", 1.0)),
            max_keep=m.get("max_keep", None),
        )


@dataclasses.dataclass(frozen=True)
class MaskGrid:
    """Token-grid geometry: (T, H, W) in tokens."""

    t: int
    h: int
    w: int

    @property
    def n(self) -> int:
        return self.t * self.h * self.w

    @staticmethod
    def from_data_cfg(crop_size: int, patch_size: int, num_frames: int, tubelet_size: int):
        return MaskGrid(t=num_frames // tubelet_size, h=crop_size // patch_size,
                        w=crop_size // patch_size)


def _ctx_dur(spec: MaskSpec, grid: MaskGrid) -> int:
    """Frames the context may span; later frames are always predicted."""
    return max(1, int(grid.t * spec.max_temporal_keep))


def expected_pred_coverage(spec: MaskSpec, grid: MaskGrid) -> float:
    """Expected fraction of tokens in the union of ``num_blocks`` mid-scale
    blocks, independent placements, plus the always-predicted late frames."""
    s = 0.5 * (spec.spatial_scale[0] + spec.spatial_scale[1])
    ts = 0.5 * (spec.temporal_scale[0] + spec.temporal_scale[1])
    t_blocks = max(1, int(grid.t * ts))
    spatial_cov = 1.0 - (1.0 - min(1.0, s)) ** spec.num_blocks
    frac_ctx_dur = _ctx_dur(spec, grid) / grid.t
    cov_within = spatial_cov * (t_blocks / grid.t)
    return min(1.0, cov_within * frac_ctx_dur + (1.0 - frac_ctx_dur))


def resolve_keep_counts(spec: MaskSpec, grid: MaskGrid) -> Tuple[int, int]:
    """Analytic (K_enc, K_pred) for fixed mode."""
    k_pred = int(round(grid.n * expected_pred_coverage(spec, grid)))
    n_late = (grid.t - _ctx_dur(spec, grid)) * grid.h * grid.w
    k_pred = max(k_pred, n_late + 1)
    k_pred = min(max(k_pred, 1), grid.n - 1)
    k_enc = grid.n - k_pred
    if spec.max_keep is not None:
        k_enc = min(k_enc, int(spec.max_keep))
    return k_enc, k_pred


class HostMaskGenerator:
    """Reference-distribution mask generator for one spec (numpy): a
    per-step block size from a counter-seeded rng shared across the batch,
    a per-sample union of ``num_blocks`` blocks, empty contexts rejected,
    every sample truncated to the batch minimum (reference
    multiblock3d.py:66-203)."""

    def __init__(self, spec: MaskSpec, grid: MaskGrid, seed: int = 0):
        self.spec = spec
        self.grid = grid
        self.seed = seed
        self._counter = -1

    def step(self) -> int:
        self._counter += 1
        return self._counter

    def _block_size(self, rng: np.random.Generator):
        g, s = self.grid, self.spec
        t_scale = s.temporal_scale[0] + rng.random() * (s.temporal_scale[1] - s.temporal_scale[0])
        t = max(1, int(g.t * t_scale))
        s_scale = s.spatial_scale[0] + rng.random() * (s.spatial_scale[1] - s.spatial_scale[0])
        num_keep = int(g.h * g.w * s_scale)
        ar = s.aspect_ratio[0] + rng.random() * (s.aspect_ratio[1] - s.aspect_ratio[0])
        h = min(int(round(math.sqrt(num_keep * ar))), g.h)
        w = min(int(round(math.sqrt(num_keep / ar))), g.w)
        return t, max(1, h), max(1, w)

    def __call__(self, batch_size: int, chunk: int = 0, _it: Optional[int] = None):
        """One per-device batch: ([B, K_enc], [B, K_pred]) int32, batch-min
        truncated. ``chunk`` names the device whose batch this is: the block
        size is shared across chunks (drawn from (seed, step)), placements
        come from a chunk-keyed stream, so devices get i.i.d. masks; chunk 0
        keeps the single-stream key. ``_it`` reuses a step already taken."""
        g, s = self.grid, self.spec
        it = self.step() if _it is None else _it
        bt, bh, bw = self._block_size(np.random.default_rng((self.seed, it)))
        rng = np.random.default_rng((self.seed, it, 1) if chunk == 0
                                    else (self.seed, it, 1, chunk))
        ctx_dur = _ctx_dur(s, g)
        encs, preds = [], []
        min_enc, min_pred = g.n, g.n
        for _ in range(batch_size):
            while True:
                keep = np.ones((g.t, g.h, g.w), dtype=bool)
                for _ in range(s.num_blocks):
                    top = rng.integers(0, g.h - bh + 1)
                    left = rng.integers(0, g.w - bw + 1)
                    start = rng.integers(0, g.t - bt + 1)
                    keep[start:start + bt, top:top + bh, left:left + bw] = False
                if ctx_dur < g.t:
                    keep[ctx_dur:] = False
                flat = keep.reshape(-1)
                enc_idx = np.flatnonzero(flat)
                if enc_idx.size:
                    break
            pred_idx = np.flatnonzero(~flat)
            encs.append(enc_idx)
            preds.append(pred_idx)
            min_enc = min(min_enc, enc_idx.size)
            min_pred = min(min_pred, pred_idx.size)
        if s.max_keep is not None:
            min_enc = min(min_enc, int(s.max_keep))
        enc = np.stack([e[:min_enc] for e in encs]).astype(np.int32)
        pred = np.stack([p[:min_pred] for p in preds]).astype(np.int32)
        return enc, pred


def calibrate_keep_counts(spec: MaskSpec, grid: MaskGrid, batch_size: int,
                          iters: int = 25, seed: int = 1234) -> Tuple[int, int]:
    """(K_enc, K_pred): the means of the host generator's batch-min sizes
    over ``iters`` deterministic draws at ``batch_size`` -- the fixed-K
    analogue of the reference's effective shapes."""
    gen = HostMaskGenerator(spec, grid, seed=seed)
    enc_sizes, pred_sizes = [], []
    for _ in range(iters):
        enc, pred = gen(batch_size)
        enc_sizes.append(enc.shape[1])
        pred_sizes.append(pred.shape[1])
    k_enc = max(1, min(int(round(float(np.mean(enc_sizes)))), grid.n - 1))
    k_pred = max(1, min(int(round(float(np.mean(pred_sizes)))), grid.n - 1))
    if spec.max_keep is not None:
        k_enc = min(k_enc, int(spec.max_keep))
    return k_enc, k_pred


class MaskCollator:
    """Host multi-spec collator of the padded mode: ``collate_chunks``
    returns per-spec lists of [batch_size, K_c] chunks, one per device,
    each with its own batch-min K (the reference's per-GPU collate)."""

    def __init__(self, specs: Sequence[MaskSpec], grid: MaskGrid, seed: int = 0):
        self.generators = [HostMaskGenerator(sp, grid, seed) for sp in specs]

    def set_step(self, step: int):
        """O(1) resume: the next collate draws step ``step``."""
        for gen in self.generators:
            gen._counter = step - 1

    def __call__(self, batch_size: int):
        out_e, out_p = [], []
        for gen in self.generators:
            e, p = gen(batch_size)
            out_e.append(e)
            out_p.append(p)
        return out_e, out_p

    def collate_chunks(self, batch_size: int, n_chunks: int):
        """``n_chunks`` per-device collates of ``batch_size`` samples on one
        shared counter step; deterministic in (seed, step, chunk)."""
        out_e, out_p = [], []
        for gen in self.generators:
            it = gen.step()
            es, ps = [], []
            for c in range(n_chunks):
                e, p = gen(batch_size, chunk=c, _it=it)
                es.append(e)
                ps.append(p)
            out_e.append(es)
            out_p.append(ps)
        return out_e, out_p


def _lane_cap(k, headroom: float, multiple: int, n: int) -> int:
    """k * headroom rounded up to ``multiple``, within [multiple, n]."""
    c = int(np.ceil(k * headroom / multiple) * multiple)
    return min(max(c, multiple), n)


def calibrate_pad_caps(spec: MaskSpec, grid: MaskGrid, batch_size: int,
                       iters: int = 40, seed: int = 4321, headroom: float = 1.05,
                       multiple: int = 128) -> Tuple[int, int]:
    """(enc_cap, pred_cap): the empirical max over ``iters`` draws plus
    headroom, rounded up to ``multiple``; heavier masks truncate in
    ``pad_masks``."""
    gen = HostMaskGenerator(spec, grid, seed=seed)
    enc_max = pred_max = 0
    for _ in range(iters):
        enc, pred = gen(batch_size)
        enc_max = max(enc_max, enc.shape[1])
        pred_max = max(pred_max, pred.shape[1])
    return (_lane_cap(enc_max, headroom, multiple, grid.n),
            _lane_cap(pred_max, headroom, multiple, grid.n))


def _record_draws(specs, grid, batch_size, iters, seed, n_chunks) -> np.ndarray:
    """[iters, S, 2] per-step (K_enc, K_pred) of each spec, the max over
    ``n_chunks`` per-device chunks."""
    gens = [HostMaskGenerator(sp, grid, seed=seed) for sp in specs]
    if n_chunks > 1:
        iters = max(40, iters // n_chunks)
    rec = np.empty((iters, len(specs), 2), np.int64)
    for i in range(iters):
        for s, gen in enumerate(gens):
            it = gen.step()
            ke = kp = 0
            for c in range(n_chunks):
                e, p = gen(batch_size, chunk=c, _it=it)
                ke = max(ke, e.shape[1])
                kp = max(kp, p.shape[1])
            rec[i, s] = (ke, kp)
    return rec


def calibrate_pad_tiers(specs: Sequence[MaskSpec], grid: MaskGrid, batch_size: int,
                        iters: int = 200, fractions: Sequence[float] = (0.6, 0.9),
                        seed: int = 4321, headroom: float = 1.05, multiple: int = 128,
                        n_chunks: int = 1, mode: str = "total"):
    """Joint cap tiers (meta.pad_tier_scope: joint): an ascending list of
    per-spec (enc_cap, pred_cap) lists from ``iters`` joint draws; the last
    tier is the max * headroom worst case. mode "total" takes prefix
    envelopes of the draws sorted by total tokens, "field" each field's own
    quantile. Adjacent equal tiers are merged."""
    rec = _record_draws(specs, grid, batch_size, iters, seed, n_chunks)
    iters = rec.shape[0]
    cap = lambda k, hr: _lane_cap(k, hr, multiple, grid.n)
    tiers = []
    if mode == "field":
        for f in sorted(fractions):
            env = np.quantile(rec, f, axis=0)
            tier = [(cap(env[s, 0], 1.0), cap(env[s, 1], 1.0)) for s in range(len(specs))]
            if not tiers or tier != tiers[-1]:
                tiers.append(tier)
        env = rec.max(axis=0)
        tier = [(cap(env[s, 0], headroom), cap(env[s, 1], headroom))
                for s in range(len(specs))]
        if not tiers or tier != tiers[-1]:
            tiers.append(tier)
        return tiers
    rec = rec[np.argsort(rec.sum(axis=(1, 2)), kind="stable")]
    cuts = [max(1, int(round(f * iters))) for f in fractions] + [iters]
    for cut in sorted(set(cuts)):
        env = rec[:cut].max(axis=0)
        hr = headroom if cut == iters else 1.0
        tier = [(cap(env[s, 0], hr), cap(env[s, 1], hr)) for s in range(len(specs))]
        if not tiers or tier != tiers[-1]:
            tiers.append(tier)
    return tiers


def calibrate_pad_ladders(specs: Sequence[MaskSpec], grid: MaskGrid, batch_size: int,
                          iters: int = 200, fractions: Sequence[float] = (0.6, 0.9),
                          seed: int = 4321, headroom: float = 1.05, multiple: int = 128,
                          n_chunks: int = 1):
    """Per-spec cap ladders (meta.pad_tier_scope: spec, the default): for
    each spec an ascending list of (enc_cap, pred_cap) rungs at its own
    per-field quantiles, the last rung its max * headroom worst case."""
    rec = _record_draws(specs, grid, batch_size, iters, seed, n_chunks)
    cap = lambda k, hr: _lane_cap(k, hr, multiple, grid.n)
    ladders = []
    for s in range(len(specs)):
        rs = rec[:, s]
        rungs = []
        for f in sorted(fractions):
            qe, qp = np.quantile(rs, f, axis=0)
            rung = (cap(qe, 1.0), cap(qp, 1.0))
            if not rungs or rung != rungs[-1]:
                rungs.append(rung)
        env = rs.max(axis=0)
        rung = (cap(env[0], headroom), cap(env[1], headroom))
        if not rungs or rung != rungs[-1]:
            rungs.append(rung)
        ladders.append(rungs)
    return ladders


def _max_k(x) -> int:
    """K of a [B, K] array, or the largest K of a list of chunks."""
    return max(a.shape[1] for a in x) if isinstance(x, (list, tuple)) else x.shape[1]


def select_pad_rungs(ladders, me_list, mp_list) -> tuple:
    """Per spec, the smallest rung covering this step's K (else the last,
    where pad_masks truncates)."""
    out = []
    for me, mp, rungs in zip(me_list, mp_list, ladders):
        ke, kp = _max_k(me), _max_k(mp)
        pick = len(rungs) - 1
        for r, (ce, cp) in enumerate(rungs[:-1]):
            if ke <= ce and kp <= cp:
                pick = r
                break
        out.append(pick)
    return tuple(out)


def select_pad_tier(tiers, me_list, mp_list) -> int:
    """The smallest joint tier covering every spec's K this step, else the
    last."""
    for t, tier in enumerate(tiers[:-1]):
        if all(_max_k(me) <= ce and _max_k(mp) <= cp
               for me, mp, (ce, cp) in zip(me_list, mp_list, tier)):
            return t
    return len(tiers) - 1


def _block_size(generator: torch.Generator, spec: MaskSpec, grid: MaskGrid):
    """Per-step block geometry (t, h, w) in tokens, 0-d int tensors on the
    generator's device (reference multiblock3d.py:106-137)."""
    r = torch.rand(3, generator=generator, device=generator.device)
    min_t, max_t = spec.temporal_scale
    t = (grid.t * (min_t + r[0] * (max_t - min_t))).to(torch.int32).clamp(min=1)
    min_s, max_s = spec.spatial_scale
    num_keep = grid.h * grid.w * (min_s + r[1] * (max_s - min_s))
    min_ar, max_ar = spec.aspect_ratio
    ar = min_ar + r[2] * (max_ar - min_ar)
    h = torch.round(torch.sqrt(num_keep * ar)).to(torch.int32).clamp(1, grid.h)
    w = torch.round(torch.sqrt(num_keep / ar)).to(torch.int32).clamp(1, grid.w)
    return t, h, w


def sample_masks(generator: torch.Generator, batch_size: int, spec: MaskSpec,
                 grid: MaskGrid, k_enc: int, k_pred: int):
    """Fixed-K sampling: ([B, K_enc], [B, K_pred]) int64 sorted token
    indices on the generator's device, disjoint in every sample."""
    dev = generator.device
    bt, bh, bw = _block_size(generator, spec, grid)
    nb = spec.num_blocks
    # per-sample block corners, uniform over the valid placements
    u = torch.rand((batch_size, nb, 3), generator=generator, device=dev)
    top = (u[..., 0] * (grid.h + 1 - bh)).floor().long()[..., None, None, None]
    left = (u[..., 1] * (grid.w + 1 - bw)).floor().long()[..., None, None, None]
    start = (u[..., 2] * (grid.t + 1 - bt)).floor().long()[..., None, None, None]
    tt = torch.arange(grid.t, device=dev)[:, None, None]
    hh = torch.arange(grid.h, device=dev)[None, :, None]
    ww = torch.arange(grid.w, device=dev)[None, None, :]
    blocks = ((tt >= start) & (tt < start + bt) & (hh >= top) & (hh < top + bh)
              & (ww >= left) & (ww < left + bw))          # [B, nb, T, H, W]
    late = (tt >= _ctx_dur(spec, grid)).expand(grid.t, grid.h, grid.w)
    union = (blocks.any(dim=1) | late).reshape(batch_size, grid.n)
    noise = torch.rand((batch_size, grid.n), generator=generator, device=dev)
    late = late.reshape(1, grid.n)
    pred_score = 2.0 * late.float() + union.float() + noise
    pred_idx = pred_score.topk(k_pred, dim=1).indices
    in_pred = torch.zeros_like(noise).scatter_(1, pred_idx, 1.0)
    enc_idx = (2.0 * (1.0 - in_pred) + noise).topk(k_enc, dim=1).indices
    return enc_idx.sort(dim=1).values, pred_idx.sort(dim=1).values


def sample_masks_for_specs(
    generator: torch.Generator,
    batch_size: int,
    specs: Sequence[MaskSpec],
    grid: MaskGrid,
    keep_counts: Sequence[Tuple[int, int]],
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """All mask configs of one train step, drawn in order from
    ``generator`` (the caller seeds it from the step)."""
    masks_enc, masks_pred = [], []
    for spec, (ke, kp) in zip(specs, keep_counts):
        me, mp = sample_masks(generator, batch_size, spec, grid, ke, kp)
        masks_enc.append(me)
        masks_pred.append(mp)
    return masks_enc, masks_pred
