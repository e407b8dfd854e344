"""Peaks of the card and the analytic work of the cells' calls, kept here so
that a change to the program cannot change the yardstick.

``vit_flops_per_token`` and ``train_step_flops`` are copies of
jepa_tpu_torch/utils/logging.py's (matmul FLOPs only, remat recompute not
counted). ``attn_bound_ms`` and ``fc1_bound_ms`` are copies of the bound
arithmetic of chip_smoke.py: the least time of a call is the largest of its
MMA FLOPs at the bf16 tensor-core peak, one exp2 per attention score at the
SFU rate, and its bytes moved once at the HBM rate.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# NVIDIA H100 SXM 80 GB, data sheet, dense rates
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# 132 SMs x 16 exp2 a clock an SM (sm_90 SFU throughput) at the 1,980 MHz max SM clock
PEAK_EXP2_PER_S = 132 * 16 * 1.98e9
BF16_BYTES = 2


def vit_flops_per_token(dim: int, depth: int, mlp_ratio: float = 4.0,
                        seq_len: int = 1568) -> float:
    """Forward FLOPs per token of a pre-LN ViT block stack (matmuls only)."""
    per_block = 2 * (4 * dim * dim + 2 * dim * int(dim * mlp_ratio)) + 2 * 2 * seq_len * dim
    return depth * per_block


def train_step_flops(*, enc_dim: int, enc_depth: int, enc_mlp: float, pred_dim: int,
                     pred_depth: int, n_full: int, ctx_lens: Iterable[int],
                     tgt_lens: Iterable[int], batch: int, patch_dim: int) -> float:
    """Analytic matmul FLOPs of one V-JEPA update (forward + 2x backward of
    the differentiated forwards; the target forward has no backward)."""
    def stack(dim, depth, mlp, seq):
        return seq * vit_flops_per_token(dim, depth, mlp, seq)

    ctx_lens, tgt_lens = list(ctx_lens), list(tgt_lens)
    tgt = stack(enc_dim, enc_depth, enc_mlp, n_full) + 2 * n_full * patch_dim * enc_dim
    ctx = sum(stack(enc_dim, enc_depth, enc_mlp, k) + 2 * n_full * patch_dim * enc_dim
              for k in ctx_lens)
    pred = sum(stack(pred_dim, pred_depth, 4.0, kc + kt)
               + 2 * (kc * enc_dim * pred_dim + kt * pred_dim * enc_dim)
               for kc, kt in zip(ctx_lens, tgt_lens))
    return batch * (tgt + 3.0 * (ctx + pred))


def serve_flops_per_clip(*, dim: int, depth: int, mlp_ratio: float, n: int, patch_dim: int,
                         num_classes: int, probe_mlp_ratio: float = 4.0) -> float:
    """Matmul FLOPs of one clip through the encoder and a depth-1 attentive
    probe with one query: the patch embedding, the blocks, the probe's q and
    kv projections, its one-query attention, its MLP and the linear head."""
    enc = n * vit_flops_per_token(dim, depth, mlp_ratio, n) + 2 * n * patch_dim * dim
    probe = (2 * dim * dim + 2 * n * dim * 2 * dim + 2 * 2 * n * dim
             + 2 * 2 * dim * int(dim * probe_mlp_ratio) + 2 * dim * num_classes)
    return float(enc + probe)


def attn_bound_ms(b: int, n: int, h: int, c: int, products: int, in_bytes: float,
                  out_bytes: float, pairs=None) -> Tuple[float, str]:
    """Least time of one attention call: the largest of ``products`` N x N x c
    matmuls per (batch, head) at the bf16 peak, one exp2 per score, and
    moving the inputs and outputs once. Returns (ms, which)."""
    pairs = b * n * n if pairs is None else pairs
    t = {"MMA": products * 2.0 * h * pairs * c / PEAK_BF16_FLOPS * 1e3,
         "exp2": 1.0 * h * pairs / PEAK_EXP2_PER_S * 1e3,
         "bytes": (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3}
    which = max(t, key=t.get)
    return t[which], which


def attn_fwd_bound_ms(b: int, n: int, h: int, c: int) -> float:
    """Self-attention forward over a fused bf16 qkv: reads q, k, v, writes o
    and the fp32 log-sum-exp; two products."""
    hc = h * c
    qkv, o, vec = b * n * 3 * hc * BF16_BYTES, b * n * hc * BF16_BYTES, b * h * n * 4
    return attn_bound_ms(b, n, h, c, 2, qkv, o + vec)[0]


def attn_bwd_bound_ms(b: int, n: int, h: int, c: int) -> float:
    """Its backward: reads q, k, v, do, lse and delta, writes dq, dk, dv; five
    products (s and p recomputed once, dv, dp, dq and dk)."""
    hc = h * c
    qkv, o, vec = b * n * 3 * hc * BF16_BYTES, b * n * hc * BF16_BYTES, b * h * n * 4
    return attn_bound_ms(b, n, h, c, 5, qkv + o + 2 * vec, qkv)[0]


def fc1_bound_ms(m: int, k: int, f: int, outputs: int = 1) -> float:
    """Least time of a bf16 fc1 + bias + GELU: the product at the bf16 peak,
    or reading x, w and the fp32 bias and writing the bf16 outputs once."""
    t_ops = 2.0 * m * k * f / PEAK_BF16_FLOPS * 1e3
    t_bytes = (2 * m * k + 2 * f * k + 4 * f + outputs * 2 * m * f) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes)


def update_attention_calls(*, n_full: int, heads: int, head_dim: int, depth: int,
                           pred_heads: int, pred_head_dim: int, pred_depth: int,
                           keep: Sequence[Tuple[int, int]]):
    """(n, heads, head dim, layers, with backward) of every self-attention
    stack of one update: the target forward, then per mask config the context
    encoder and the predictor over context + targets."""
    calls = [(n_full, heads, head_dim, depth, False)]
    for ke, kp in keep:
        calls.append((ke, heads, head_dim, depth, True))
        calls.append((ke + kp, pred_heads, pred_head_dim, pred_depth, True))
    return calls


def attention_bound_ms(calls, batch: int) -> float:
    """Sum of the bounds of ``calls`` (``update_attention_calls``) at ``batch``."""
    total = 0.0
    for n, h, c, layers, backward in calls:
        per = attn_fwd_bound_ms(batch, n, h, c)
        if backward:
            per += attn_bwd_bound_ms(batch, n, h, c)
        total += layers * per
    return total
