"""Flash self-attention over the fused qkv projection, forward only
(counterpart of jepa_tpu/ops/flash_attention.py::flash_self_attention).

The qkv projection stays a plain matmul, as the JAX package leaves it to
XLA (``_project_qkv``). Its token-major output [B, N, 3*H*c] feeds the
attention directly: for a CUDA tensor the hand-written Hopper kernel H1
(``csrc/flash_attention.cu``), for a CPU tensor ``flash_self_attention_ref``,
the plain PyTorch version of the same math. Both return o token-major
[B, N, H*c] and lse [B, H, N] fp32 in base-2 units.

Numerics: base-2 softmax with scale*log2e folded into q, which is rounded
to the compute dtype before QK^T; p is rounded to the compute dtype before
PV and the denominator is the fp32 sum of the rounded p. The softmax is
taken against the row max (the TPU kernel's static shift C=64 agrees
within bf16 rounding of p over the LayerNorm-bounded logit range, and the
row max is exact at every range). Not ported: the TPU head-dim padding and
the Mosaic block pickers; H1 takes c in {64, 80} directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (64, 80)

launches = 0  # H1 launches in this process (wrapper-counted)


def _project_qkv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] @ w.T ([3HC, D], nn.Linear layout) + b, fp32 sum, cast to x.dtype."""
    from jepa_tpu_torch.models.transformer import matmul_f32

    return (matmul_f32(x, w) + b.float()).to(x.dtype)


def flash_self_attention_ref(
    qkv: torch.Tensor,
    num_heads: int,
    scale: float,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of H1. qkv [B, N, 3*H*c] -> (o [B, N, H*c], lse [B, H, N])."""
    b, n, w3 = qkv.shape
    hc = w3 // 3
    c = hc // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, n, 3, num_heads, c).unbind(2)  # [B, N, H, c]
    qs = (q.float() * (scale * _LOG2E)).to(dt)
    s = torch.einsum("bqhc,bkhc->bhqk", qs.float(), k.float())
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s,
                        torch.tensor(_NEG_INF, dtype=torch.float32))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m).to(dt)
    l = p.float().sum(dim=-1, keepdim=True)  # [B, H, N, 1]
    o = torch.einsum("bhqk,bkhc->bhqc", p.float(), v.float()) / l
    o = o.to(dt).permute(0, 2, 1, 3).reshape(b, n, hc)
    lse = (m + torch.log2(l)).squeeze(-1)
    return o, lse


def flash_self_attention_cuda(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch H1 on qkv's current stream. qkv [B, N, 3*H*c] bf16, c in {64, 80}."""
    global launches
    from jepa_tpu_torch.ops._build import check, load_library

    if not qkv.is_cuda:
        raise ValueError("flash_self_attention_cuda: qkv must be a CUDA tensor")
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"flash_self_attention_cuda takes bf16 qkv, got {qkv.dtype}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError("flash_self_attention_cuda is forward-only; "
                                  "call it under torch.no_grad()")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"flash_self_attention_cuda: bad qkv shape "
                         f"{tuple(qkv.shape)} for {num_heads} heads")
    b, n, w3 = qkv.shape
    c = w3 // (3 * num_heads)
    if c not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_self_attention_cuda: head dim {c} not in {KERNEL_HEAD_DIMS}")
    if n < 1 or b < 1:
        raise ValueError("flash_self_attention_cuda: empty input")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_self_attention_cuda: qkv must be contiguous "
                         "and 16-byte aligned")
    o = torch.empty((b, n, num_heads * c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    lib = load_library()
    fn = lib.jt_flash_fwd_c64 if c == 64 else lib.jt_flash_fwd_c80
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    check(fn(qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, num_heads,
             float(scale) * _LOG2E, stream), f"jt_flash_fwd_c{c}")
    launches += 1
    return o, lse


def flash_self_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused-projection flash self-attention, forward only.

    x: [B, N, D] (compute dtype); w_qkv: [3*H*c, D] (nn.Linear layout; rows
    q|k|v, each head-major); b_qkv: [3*H*c]. Returns o [B, N, H*c]
    token-major, the input of the output projection. H1 runs for a CUDA
    tensor (with ``kv_mask`` it raises: H1 takes no key mask yet), the
    plain version for a CPU tensor.
    """
    hc = w_qkv.shape[0] // 3
    if hc % num_heads:
        raise ValueError(f"qkv width {3 * hc} does not split into {num_heads} heads")
    if scale is None:
        scale = (hc // num_heads) ** -0.5
    qkv = _project_qkv(x, w_qkv.to(x.dtype), b_qkv)
    if qkv.is_cuda:
        if kv_mask is not None:
            raise NotImplementedError("H1 takes no kv_mask yet")
        o, _ = flash_self_attention_cuda(qkv.contiguous(), num_heads, scale)
    else:
        o, _ = flash_self_attention_ref(qkv, num_heads, scale, kv_mask=kv_mask)
    return o
