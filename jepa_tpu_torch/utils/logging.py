"""Logging: console, CSV, meters and the analytic FLOP count of an update
(counterpart of jepa_tpu/utils/logging.py; reference src/utils/logging.py).
The app times a step on the host clock around work that ends in a
device synchronisation.
"""

from __future__ import annotations

import logging
import sys
from typing import Iterable, Tuple


def get_logger(name=None, rank: int = 0, force: bool = False):
    """INFO on rank 0, ERROR elsewhere (reference app/main.py:35-38)."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO if rank == 0 else logging.ERROR, force=force)
    return logging.getLogger(name)


class CSVLogger:
    """Append-on-every-call CSV writer (reference logging.py:44-62)."""

    def __init__(self, fname: str, *argv: Tuple[str, str]):
        self.fname = fname
        self.types = [v[0] for v in argv]
        with open(self.fname, "+a") as f:
            for i, v in enumerate(argv, 1):
                print(v[1], end="," if i < len(argv) else "\n", file=f)

    def log(self, *argv):
        with open(self.fname, "+a") as f:
            for i, (t, v) in enumerate(zip(self.types, argv), 1):
                end = "," if i < len(argv) else "\n"
                print(t % v, end=end, file=f)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.max = float("-inf")
        self.min = float("inf")

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.max = max(val, self.max)
        self.min = min(val, self.min)
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)


def vit_flops_per_token(dim: int, depth: int, mlp_ratio: float = 4.0, seq_len: int = 1568) -> float:
    """Forward FLOPs per token of a pre-LN ViT block stack (matmuls only)."""
    per_block = 2 * (4 * dim * dim + 2 * dim * int(dim * mlp_ratio)) + 2 * 2 * seq_len * dim
    return depth * per_block


def train_step_flops(
    *,
    enc_dim: int,
    enc_depth: int,
    enc_mlp: float,
    pred_dim: int,
    pred_depth: int,
    n_full: int,
    ctx_lens: Iterable[int],
    tgt_lens: Iterable[int],
    batch: int,
    patch_dim: int,
) -> float:
    """Analytic matmul FLOPs of one fused V-JEPA update (fwd + 2x bwd).

    Terms: target fwd over n_full tokens, per-mask context fwd, per-mask
    predictor fwd over (ctx+tgt), patch embeds; backward ~2x the
    differentiated forwards (target encoder excluded: no grad).
    """
    def stack(dim, depth, mlp, seq):
        return seq * vit_flops_per_token(dim, depth, mlp, seq)

    tgt = stack(enc_dim, enc_depth, enc_mlp, n_full) + 2 * n_full * patch_dim * enc_dim
    ctx = sum(
        stack(enc_dim, enc_depth, enc_mlp, k) + 2 * n_full * patch_dim * enc_dim
        for k in ctx_lens
    )
    pred = sum(
        stack(pred_dim, pred_depth, 4.0, kc + kt)
        + 2 * (kc * enc_dim * pred_dim + kt * pred_dim * enc_dim)
        for kc, kt in zip(ctx_lens, tgt_lens)
    )
    return batch * (tgt + 3.0 * (ctx + pred))
