"""Transformer primitives: LayerNorm, linear, MLP, pre-LN blocks
(counterpart of jepa_tpu/models/transformer.py).

Modules carry the reference zoo's state_dict names (``norm1``,
``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``); the
forward math lives in functions that mirror the JAX package's rounding:

  * LayerNorm runs in fp32 and returns the input dtype.
  * ``linear`` sums in fp32 and adds the bias in fp32 before the cast to
    the compute dtype.
  * MLP activation: fused fc1 (``ops.fused_mlp.linear_gelu``) when
    enabled: H3 on grad-free forwards, H8 and its plain backward under a
    gradient (``fused_mlp='force'`` on a trainable block); otherwise
    linear, then the exp2-erfc GELU for bf16 or exact erf for fp32.
  * Residual adds happen in the compute dtype.

Blocks are an ``nn.ModuleList`` run by a Python loop, each optionally
under activation checkpointing (``run_blocks``'s ``remat``, the JAX
package's meanings).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from jepa_tpu_torch.models.initializers import (
    init_layernorm_,
    init_linear_,
    residual_rescale,
)
from jepa_tpu_torch.ops import remat as remat_lib
from jepa_tpu_torch.ops.attention import dot_product_attention, resolve_flash


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    dim: int
    num_heads: int
    mlp_hidden: int
    ln_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    qk_scale: Optional[float] = None
    # fused fc1 + GELU kernel: False | True (on CUDA tensors) | 'force'
    # (always; on the CPU that is the kernel's plain version). Under a
    # gradient it runs H8 and the A&S erf GELU, as the JAX package's vjp.
    fused_mlp: object = False

    def __post_init__(self):
        if self.dim % self.num_heads != 0:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by num_heads ({self.num_heads})")


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, F], one dtype, with an fp32 result summed in fp32.
    bf16 on CUDA asks cuBLAS for an fp32 output; bf16 on the CPU upcasts
    the operands (exact), since a CPU bf16 matmul rounds its output."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class MatmulF32(torch.autograd.Function):
    """x [..., K] @ w.T (w [F, K]) -> fp32 [..., F], differentiable.

    cuBLAS's fp32-output bf16 GEMM (``aten::mm.dtype``) has no autograd
    formula, so the backward is written here: dx = g @ w and dw = g.T @ x
    as products in the operands' dtype with fp32 sums, cast to x's and
    w's dtypes. The cotangent g reaching a ``linear`` comes through the
    cast of its output to the compute dtype, so casting g to that dtype is
    exact and both products equal the JAX package's dot transpose up to
    summation order."""

    @staticmethod
    def saved(x, w):
        """What the forward saves for the backward, in order (what a kept
        output's replay under remat='attn' hands checkpoint, ``linear_f32``)."""
        return x, w

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(*MatmulF32.saved(x, w))
        y = _mm_f32(x.reshape(-1, x.shape[-1]), w.t())
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g2, w).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(g2.t(), x.reshape(-1, x.shape[-1])).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w.T (w [F, K], one dtype) with an fp32 result summed in
    fp32, on either device; differentiable through ``MatmulF32`` when a
    gradient is wanted (a grad-free call skips the Function's overhead)."""
    if _differentiated(x, w):
        return MatmulF32.apply(x, w)
    return _mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])


def _differentiated(x: torch.Tensor, w: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def linear_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
               keep: bool = False) -> torch.Tensor:
    """x @ w.T + b (w [F, K], x's dtype), summed and biased in fp32, cast
    to ``dtype``. ``keep``: the output is kept under remat='attn'
    (``ops.remat.keep``); the recomputation reads it back and hands
    checkpoint what ``MatmulF32`` saved."""
    out = lambda: (matmul_f32(x, w) + b.float()).to(dtype)
    if not keep:
        return out()
    return remat_lib.keep(out, packs=MatmulF32.saved(x, w) if _differentiated(x, w) else ())


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis; returns x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * ln.weight.float() + ln.bias.float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, lin: nn.Linear, compute_dtype: torch.dtype,
           keep: bool = False) -> torch.Tensor:
    """``linear_f32`` of an ``nn.Linear`` in the compute dtype."""
    return linear_f32(x.to(compute_dtype), lin.weight.to(compute_dtype), lin.bias,
                      compute_dtype, keep)


def mlp(x: torch.Tensor, m: "Mlp", cfg: BlockCfg) -> torch.Tensor:
    from jepa_tpu_torch.ops.fused_mlp import GeluFast, linear_gelu, resolve_fused_mlp

    cd = cfg.compute_dtype
    if cfg.fused_mlp and (cfg.fused_mlp == "force" or resolve_fused_mlp(x)):
        h = linear_gelu(x.to(cd), m.fc1.weight.to(cd), m.fc1.bias)
    else:
        h = linear(x, m.fc1, cd, keep=True)  # the JAX package's "fc1_out"
        if cd == torch.bfloat16:
            h = GeluFast.apply(h)
        else:
            h = F.gelu(h.float()).to(cd)
    return linear(h, m.fc2, cd)


def self_attention(x: torch.Tensor, attn: "Attention", cfg: BlockCfg,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused-qkv multi-head self-attention. x: [B, N, D]."""
    b, n, d = x.shape
    h = cfg.num_heads
    cd = cfg.compute_dtype
    if resolve_flash(cfg.attn_impl, n, n, x):
        from jepa_tpu_torch.ops.flash_attention import flash_self_attention

        out = flash_self_attention(
            x.to(cd), attn.qkv.weight.to(cd), attn.qkv.bias, h,
            kv_mask=kv_mask, scale=cfg.qk_scale)  # [B, N, D] token-major
        return linear(out, attn.proj, cd)
    qkv = linear(x, attn.qkv, cd).reshape(b, n, 3, h, d // h)
    q, k, v = qkv.unbind(2)
    out = dot_product_attention(q, k, v, kv_mask=kv_mask, scale=cfg.qk_scale,
                                impl=cfg.attn_impl)
    return linear(out.reshape(b, n, d), attn.proj, cd)


class Attention(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)


class Block(nn.Module):
    """Pre-LN block: x + attn(norm1 x); x + mlp(norm2 x)."""

    def __init__(self, cfg: BlockCfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps, device=device)
        self.attn = Attention(cfg.dim, device=device)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps, device=device)
        self.mlp = Mlp(cfg.dim, cfg.mlp_hidden, device=device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator], layer_id: int,
                     init_std: float = 0.02) -> None:
        """Reference init; layer_id (1-indexed) sets the residual rescale."""
        init_layernorm_(self.norm1)
        init_layernorm_(self.norm2)
        r = residual_rescale(layer_id)
        init_linear_(self.attn.qkv, generator, init_std)
        init_linear_(self.attn.proj, generator, init_std, rescale=r)
        init_linear_(self.mlp.fc1, generator, init_std)
        init_linear_(self.mlp.fc2, generator, init_std, rescale=r)

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return block_forward(x, self, self.cfg, kv_mask=kv_mask)


def block_forward(x: torch.Tensor, blk: Block, cfg: BlockCfg,
                  kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = layer_norm(x, blk.norm1, cfg.ln_eps)
    x = x + self_attention(y, blk.attn, cfg, kv_mask=kv_mask)
    y = layer_norm(x, blk.norm2, cfg.ln_eps)
    return x + mlp(y, blk.mlp, cfg)


def run_blocks(x: torch.Tensor, blocks: nn.ModuleList, cfg: BlockCfg,
               kv_mask: Optional[torch.Tensor] = None, collect_layers: bool = False,
               remat: object = False):
    """Run the blocks in order. Returns (final, per-layer outputs or None);
    per-layer outputs are stacked [depth, B, N, D] when collect_layers.

    remat (jepa_tpu/models/transformer.py:236-289), under a gradient:
    False: no checkpointing; True / 'full': each block is recomputed in the
    backward (the flash forward included); 'attn': each block is
    recomputed except what the JAX package's selective policy saves: the
    flash forward's (o, lse), the token-major route's qkv projection and
    the fc1 pre-activation (``ops.remat``). So LN1 (for the qkv weight's
    gradient), the out-projection, the residual, LN2, the GELU and fc2 are
    recomputed. A grad-free forward ignores it."""
    x = x.to(cfg.compute_dtype)
    layers = [] if collect_layers else None
    ckpt = None
    if remat and torch.is_grad_enabled():
        ckpt = (remat_lib.checkpoint_keeping if remat == "attn" else
                lambda fn, c: checkpoint(fn, c, use_reentrant=False, preserve_rng_state=False))
    for blk in blocks:
        fn = functools.partial(block_forward, blk=blk, cfg=cfg, kv_mask=kv_mask)
        x = fn(x) if ckpt is None else ckpt(fn, x)
        if collect_layers:
            layers.append(x)
    return x, (torch.stack(layers) if collect_layers else None)


@torch.no_grad()
def cast_matmul_weights_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every parameter of two or more dims (the matmul weights, the
    patch kernel, the probe's query tokens) in ``dtype``, in place. The
    forward casts each of them to the compute dtype at use, as the JAX
    package does, so casting once up front changes no value; biases and
    LayerNorm parameters stay fp32, as the forward reads them."""
    for p in module.parameters():
        if p.ndim >= 2:
            p.data = p.data.to(dtype)
    return module
