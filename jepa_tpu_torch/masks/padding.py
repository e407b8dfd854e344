"""Static-shape padding for host-generated (padded-mode) masks (counterpart
of jepa_tpu/masks/padding.py, numpy, the same integers).

The reference's batch-min truncation yields a different K every step;
``pad_masks`` pads the index arrays up to a cap and returns a validity
weight that the encoder and predictor take as their key mask (w > 0.5) and
the losses as token weights.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_masks(idx: np.ndarray, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """[B, K] indices -> ([B, cap] indices, [B, cap] float validity).

    Padding repeats index 0 with weight 0. K > cap truncates to the first
    cap indices, the reference's ascending ``[:min_keep]`` slice
    (multiblock3d.py:196), so a heavier-than-cap mask degrades gracefully.
    """
    b, k = idx.shape
    if k > cap:
        idx = idx[:, :cap]
        k = cap
    out = np.zeros((b, cap), dtype=np.int32)
    out[:, :k] = idx
    w = np.zeros((b, cap), dtype=np.float32)
    w[:, :k] = 1.0
    return out, w


def static_cap(n_tokens: int, frac: float, multiple: int = 128) -> int:
    """A cap sized to a coverage fraction, rounded up to a multiple."""
    cap = int(np.ceil(n_tokens * frac / multiple) * multiple)
    return min(max(cap, multiple), n_tokens)
