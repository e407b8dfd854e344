"""Attention ops (counterpart of jepa_tpu/ops/attention.py).

``xla_attention`` is the plain eager path: an einsum with an fp32 softmax
and the -1e30 key mask. It serves every attention the kernels do not
take, such as the probe's 1-query cross-attention, exactly as the JAX
package sends those to XLA. Self-attention over the fused projection runs
through ``ops.flash_attention.flash_self_attention``; attention over
separate q/k/v with the flash impl through ``ops.flash_attention.flash_attention``.

Conventions: q/k/v are [B, N, H, Dh]; ``kv_mask`` [B, Nk] bool marks valid
keys (False = padded, excluded).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention with fp32 softmax. q/k/v: [B, N, H, Dh] -> [B, Nq, H, Dh]
    in v's dtype. Products take fp32 operands (exact for bf16) so the sums
    are fp32, as XLA's preferred_element_type=float32."""
    head_dim = q.shape[-1]
    if scale is None:
        scale = head_dim**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * torch.tensor(scale, dtype=torch.float32)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits,
                             torch.tensor(_NEG_INF, dtype=torch.float32))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def resolve_flash(impl: str, nq: int, nk: int, x: torch.Tensor) -> bool:
    """Does this (impl, shape) run the flash kernel path? 'auto' takes it on
    a CUDA device when nq, nk >= 128 (the JAX rule, with CUDA in place of
    the TPU); 'flash' forces it (on the CPU that is the kernel's plain
    version); 'xla' never."""
    if impl == "xla":
        return False
    if impl == "flash":
        return True
    if impl == "auto":
        return x.is_cuda and nq >= 128 and nk >= 128
    raise ValueError(f"unknown attention impl: {impl}")


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention over token-major [B, N, H, Dh] operands.
    impl: 'auto' | 'xla' | 'flash' (``resolve_flash``). The flash path is
    ``flash_attention``: the head-major kernels H4-H7 on a CUDA tensor,
    their plain versions on a CPU tensor."""
    if resolve_flash(impl, q.shape[1], k.shape[1], q):
        from jepa_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
    return xla_attention(q, k, v, kv_mask=kv_mask, scale=scale)
