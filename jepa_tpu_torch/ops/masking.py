"""Token gathers, batch tiling and weighted means for masked forwards and
losses (counterpart of jepa_tpu/ops/masking.py)."""

from __future__ import annotations

from typing import List, Optional

import torch


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Tokens of x [B, N, D] at idx [B, K] (int, in [0, N)) -> [B, K, D]."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[-1]))


def apply_masks(x: torch.Tensor, masks: List[torch.Tensor], concat: bool = True):
    """Gather per mask [B, K_i]; concatenated on the batch axis
    ([len(masks)*B, K, D], equal K required) or a list when concat=False."""
    outs = [gather_tokens(x, m) for m in masks]
    if not concat:
        return outs
    return torch.cat(outs, dim=0)


def repeat_interleave_batch(x: torch.Tensor, b: int, repeat: int) -> torch.Tensor:
    """Tile each contiguous batch chunk of size ``b`` ``repeat`` times:
    [n*b, ...] -> [n*repeat*b, ...] (reference src/utils/tensors.py:65-71)."""
    n = x.shape[0] // b
    rest = x.shape[1:]
    out = x.reshape(n, 1, b, *rest).expand(n, repeat, b, *rest)
    return out.reshape(n * repeat * b, *rest)


def masked_mean(x: torch.Tensor, weight: Optional[torch.Tensor], dim=None,
                denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of x under optional token-validity weights ([B, K] against
    x [B, K, D], or x's own shape); weight-0 positions are excluded from
    the normalizer. ``denom`` (with ``dim`` None) replaces the normalizer,
    the sum of the broadcast weights: a data-parallel rank passes the sum
    over the global batch, so its share of the mean sums across ranks to the
    global mean."""
    if weight is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    w = weight[..., None] if weight.dim() == x.dim() - 1 else weight
    w = w.expand(x.shape).to(x.dtype)
    if dim is None:
        return (x * w).sum() / (w.sum() if denom is None else denom).clamp(min=1e-6)
    return (x * w).sum(dim=dim) / w.sum(dim=dim).clamp(min=1e-6)
