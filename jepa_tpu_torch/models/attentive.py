"""Attentive pooler / classifier, the frozen-eval probe (counterpart of
jepa_tpu/models/attentive.py).

A learnable query token cross-attends over the frozen features, then
optional self-attention blocks, then a linear head. The cross-attention
block normalizes the features (not the query), the probe's LayerNorm eps
is torch's default 1e-5, and the cross-attention's ``proj`` is defined but
never applied (``use_cross_proj=False``), as in the reference. The 1-query
attention runs the plain eager path, as the JAX package runs it in XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from jepa_tpu_torch.models.initializers import (
    init_layernorm_,
    init_linear_,
    residual_rescale,
    trunc_normal,
)
from jepa_tpu_torch.models.transformer import (
    Block,
    BlockCfg,
    Mlp,
    block_forward,
    layer_norm,
    linear,
    mlp,
)
from jepa_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class AttentiveCfg:
    embed_dim: int = 768
    num_heads: int = 12
    mlp_ratio: float = 4.0
    depth: int = 1
    num_queries: int = 1
    num_classes: int = 1000
    ln_eps: float = 1e-5
    init_std: float = 0.02
    complete_block: bool = True
    use_cross_proj: bool = False  # the reference never applies xattn.proj
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    def block_cfg(self) -> BlockCfg:
        return BlockCfg(
            dim=self.embed_dim,
            num_heads=self.num_heads,
            mlp_hidden=int(self.embed_dim * self.mlp_ratio),
            ln_eps=self.ln_eps,
            compute_dtype=self.compute_dtype,
            attn_impl=self.attn_impl,
        )


class CrossAttention(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.q = nn.Linear(dim, dim, device=device)
        self.kv = nn.Linear(dim, 2 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)


class CrossAttentionBlock(nn.Module):
    def __init__(self, cfg: AttentiveCfg, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, device=device)
        self.xattn = CrossAttention(d, device=device)
        if cfg.complete_block:
            self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, device=device)
            self.mlp = Mlp(d, int(d * cfg.mlp_ratio), device=device)


class AttentivePooler(nn.Module):
    def __init__(self, cfg: AttentiveCfg, device=None):
        super().__init__()
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_queries, cfg.embed_dim, device=device))
        self.cross_attention_block = CrossAttentionBlock(cfg, device=device)
        if cfg.depth > 1:
            bc = cfg.block_cfg()
            self.blocks = nn.ModuleList(Block(bc, device=device)
                                        for _ in range(cfg.depth - 1))


class AttentiveClassifier(nn.Module):
    def __init__(self, cfg: AttentiveCfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.pooler = AttentivePooler(cfg, device=device)
        self.linear = nn.Linear(cfg.embed_dim, cfg.num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "AttentiveClassifier":
        """Reference init: the pooler's residual projections use the
        layer-1 rescale and trailing blocks continue from layer 2."""
        cfg, std = self.cfg, self.cfg.init_std
        pooler = self.pooler
        pooler.query_tokens.copy_(trunc_normal(pooler.query_tokens.shape, generator, std=std))
        cab = pooler.cross_attention_block
        init_layernorm_(cab.norm1)
        init_linear_(cab.xattn.q, generator, std)
        init_linear_(cab.xattn.kv, generator, std)
        init_linear_(cab.xattn.proj, generator, std, rescale=residual_rescale(1))
        if cfg.complete_block:
            init_layernorm_(cab.norm2)
            init_linear_(cab.mlp.fc1, generator, std)
            init_linear_(cab.mlp.fc2, generator, std, rescale=residual_rescale(1))
        for i, blk in enumerate(getattr(pooler, "blocks", ())):
            blk.init_weights(generator, i + 2, std)
        init_linear_(self.linear, generator, std)
        return self

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return classifier_forward(self, x, self.cfg, kv_mask=kv_mask)


def init_attentive_classifier(cfg: AttentiveCfg, generator: Optional[torch.Generator] = None,
                              device=None) -> AttentiveClassifier:
    return AttentiveClassifier(cfg, device=device).init_weights(generator)


def cross_attention(q: torch.Tensor, x: torch.Tensor, xattn: CrossAttention,
                    cfg: AttentiveCfg, kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Query tokens attend over the feature sequence. q: [B,n,D], x: [B,N,D]."""
    b, n, d = q.shape
    h = cfg.num_heads
    cd = cfg.compute_dtype
    qh = linear(q, xattn.q, cd).reshape(b, n, h, d // h)
    kv = linear(x, xattn.kv, cd).reshape(b, x.shape[1], 2, h, d // h)
    k, v = kv.unbind(2)
    out = dot_product_attention(qh, k, v, kv_mask=kv_mask, impl=cfg.attn_impl)
    out = out.reshape(b, n, d)
    if cfg.use_cross_proj:
        return linear(out, xattn.proj, cd)
    return out.to(cd)


def pooler_forward(pooler: AttentivePooler, x: torch.Tensor, cfg: AttentiveCfg,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, N, D] frozen features -> [B, num_queries, D]."""
    cd = cfg.compute_dtype
    cab = pooler.cross_attention_block
    q = pooler.query_tokens.to(cd).expand(x.shape[0], -1, -1)
    xn = layer_norm(x.to(cd), cab.norm1, cfg.ln_eps)
    y = cross_attention(q, xn, cab.xattn, cfg, kv_mask=kv_mask)
    if cfg.complete_block:
        q = q + y
        qn = layer_norm(q, cab.norm2, cfg.ln_eps)
        q = q + mlp(qn, cab.mlp, cfg.block_cfg())
    else:
        q = y
    bc = cfg.block_cfg()
    for blk in getattr(pooler, "blocks", ()):
        q = block_forward(q, blk, bc)
    return q


def classifier_forward(clf: AttentiveClassifier, x: torch.Tensor, cfg: AttentiveCfg,
                       kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, N, D] -> logits [B, num_classes] fp32."""
    q = pooler_forward(clf.pooler, x, cfg, kv_mask=kv_mask)[:, 0]
    return linear(q, clf.linear, cfg.compute_dtype).float()
