"""Token gathers for masked forwards (counterpart of jepa_tpu/ops/masking.py)."""

from __future__ import annotations

from typing import List

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
