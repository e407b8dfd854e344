"""Flash self-attention over the fused qkv projection, forward and
backward (counterpart of jepa_tpu/ops/flash_attention.py::flash_self_attention
and its save-qkv custom_vjp ``_flash_tm_qkv``).

The qkv projection stays a plain matmul, as the JAX package leaves it to
XLA (``_project_qkv``), and autograd differentiates it. Its token-major
output [B, N, 3*H*c] feeds ``FlashSelfAttentionFn``:

  * forward: for a CUDA tensor the hand-written Hopper kernel H1
    (``csrc/flash_attention.cu``), for a CPU tensor
    ``flash_self_attention_ref``, the plain PyTorch version of the same
    math. Both return o token-major [B, N, H*c] and lse [B, H, N] fp32 in
    base-2 units; the Function saves (qkv, o, lse).
  * backward: delta = sum_c(do * o) in fp32 plain torch (as the JAX
    package computes it in XLA), then for a CUDA tensor the hand-written
    kernels H2 (``csrc/flash_attention_bwd.cu``: one dk/dv kernel, one dq
    kernel), for a CPU tensor ``flash_self_attention_bwd_ref``. Both
    return one token-major dqkv [B, N, 3*H*c].

Head dims outside the kernels' {32, 64, 80} that are not multiples of 32
(the predictors' 24) are zero-padded up to the next multiple of 32 in the
projection's weight and bias, and o's pad lanes are sliced off, exactly
as the JAX package does (flash_attention.py:1770-1812). That is exact: pad
q/k/v lanes are zero, so every pad gradient is zero. The rule is the same
on both devices, so the CPU tests reach the padding code.

Numerics: base-2 softmax with scale*log2e folded into q, which is rounded
to the compute dtype before QK^T; p is rounded to the compute dtype before
PV and the denominator is the fp32 sum of the rounded p. The softmax is
taken against the row max (the TPU kernel's static shift C=64 agrees
within bf16 rounding of p over the LayerNorm-bounded logit range, and the
row max is exact at every range). Not ported: the Mosaic block pickers.

Backward numerics, as the dual-tiled TPU kernels (_dq_tm_kernel,
_dkv_tm_kernel): the same bf16 q*(scale*log2e); p = exp2(s - lse) in
fp32, rounded to bf16 only as the operand of dV = p^T do; ds = p*(dp -
delta) rounded to bf16 before dK = ds^T q and dQ = ds k; dk scaled by
1/log2e and dq by ``scale``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (32, 64, 80)

# wrapper-counted launches in this process
launches = 0      # H1, every head dim
launches_by_head_dim = {c: 0 for c in KERNEL_HEAD_DIMS}  # H1, per instance
dkv_launches = 0  # H2, dk/dv kernel
dq_launches = 0   # H2, dq kernel


def reset_launch_counts() -> None:
    global launches, dkv_launches, dq_launches
    launches = dkv_launches = dq_launches = 0
    for c in launches_by_head_dim:
        launches_by_head_dim[c] = 0


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


def _check_qkv(qkv: torch.Tensor, num_heads: int, name: str) -> int:
    """Validate a kernel's qkv operand; return its head dim."""
    if not qkv.is_cuda:
        raise ValueError(f"{name}: qkv must be a CUDA tensor")
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(f"{name} takes bf16 qkv, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"{name}: bad qkv shape {tuple(qkv.shape)} for "
                         f"{num_heads} heads")
    b, n, w3 = qkv.shape
    c = w3 // (3 * num_heads)
    if c not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"{name}: head dim {c} not in {KERNEL_HEAD_DIMS}")
    if n < 1 or b < 1:
        raise ValueError(f"{name}: empty input")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    return c


def flash_self_attention_cuda(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch H1 on qkv's current stream. qkv [B, N, 3*H*c] bf16, c in
    {32, 64, 80}. Differentiable only through ``FlashSelfAttentionFn``."""
    global launches
    from jepa_tpu_torch.ops._build import check, load_library

    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError("flash_self_attention_cuda has no autograd "
                                  "of its own; use FlashSelfAttentionFn")
    c = _check_qkv(qkv, num_heads, "flash_self_attention_cuda")
    b, n, _ = qkv.shape
    o = torch.empty((b, n, num_heads * c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    lib = load_library()
    fn = getattr(lib, f"jt_flash_fwd_c{c}")
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    check(fn(qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, num_heads,
             float(scale) * _LOG2E, stream), f"jt_flash_fwd_c{c}")
    launches += 1
    launches_by_head_dim[c] += 1
    return o, lse


def _launch_bwd(kind: str, qkv, do, lse, delta, dqkv, num_heads: int,
                scale: float) -> None:
    """Check the operands of one H2 kernel (``kind`` "dkv" or "dq") and
    launch it on qkv's current stream."""
    global dkv_launches, dq_launches
    from jepa_tpu_torch.ops._build import check, load_library

    name = f"flash_bwd_{kind}_cuda"
    c = _check_qkv(qkv, num_heads, name)
    b, n, _ = qkv.shape
    hc = num_heads * c
    if do.dtype != qkv.dtype or tuple(do.shape) != (b, n, hc) or not do.is_contiguous():
        raise ValueError(f"{name}: do must be contiguous {qkv.dtype} [B, N, H*c]")
    for t, label in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, num_heads, n)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous fp32 [B, H, N]")
    if do.data_ptr() % 16:
        raise ValueError(f"{name}: do must be 16-byte aligned")
    if dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype or not dqkv.is_contiguous():
        raise ValueError(f"{name}: dqkv must be shaped like qkv")
    entry = f"jt_flash_bwd_{kind}_c{c}"
    extra = (float(scale),) if kind == "dq" else ()  # dq's accumulator scale
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    check(getattr(load_library(), entry)(
        qkv.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), b, n, num_heads, float(scale) * _LOG2E, *extra, stream), entry)
    if kind == "dq":
        dq_launches += 1
    else:
        dkv_launches += 1


def flash_bwd_dkv_cuda(qkv, do, lse, delta, dqkv, num_heads: int, scale: float) -> None:
    """Launch H2's dk/dv kernel: writes dk and dv into columns [H*c, 3*H*c)
    of dqkv [B, N, 3*H*c] bf16."""
    _launch_bwd("dkv", qkv, do, lse, delta, dqkv, num_heads, scale)


def flash_bwd_dq_cuda(qkv, do, lse, delta, dqkv, num_heads: int, scale: float) -> None:
    """Launch H2's dq kernel: writes dq into columns [0, H*c) of dqkv."""
    _launch_bwd("dq", qkv, do, lse, delta, dqkv, num_heads, scale)


def flash_self_attention_bwd_cuda(qkv, do, lse, delta, num_heads: int,
                                  scale: float) -> torch.Tensor:
    """H2: both backward kernels into one token-major dqkv [B, N, 3*H*c]."""
    dqkv = torch.empty_like(qkv)
    flash_bwd_dkv_cuda(qkv, do, lse, delta, dqkv, num_heads, scale)
    flash_bwd_dq_cuda(qkv, do, lse, delta, dqkv, num_heads, scale)
    return dqkv


def _bwd_ref_common(qkv, do, lse, delta, num_heads, scale):
    """Shared recompute of the plain backward: (q scaled, k, v, do, p, ds),
    head-major fp32 except where a bf16 rounding point is kept."""
    b, n, w3 = qkv.shape
    c = w3 // (3 * num_heads)
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, n, 3, num_heads, c).permute(2, 0, 3, 1, 4).unbind(0)
    qs = (q.float() * (scale * _LOG2E)).to(dt).float()          # [B, H, N, c]
    dof = do.reshape(b, n, num_heads, c).transpose(1, 2).float()
    s = qs @ k.float().transpose(-1, -2)                          # [B, H, N, N]
    p = torch.exp2(s - lse[..., None])
    dp = dof @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    return qs, k.float(), dof, p, ds


def flash_bwd_dkv_ref(qkv, do, lse, delta, num_heads: int, scale: float):
    """Plain version of H2's dk/dv kernel -> (dk, dv), each [B, N, H*c]."""
    b, n, _ = qkv.shape
    dt = qkv.dtype
    qs, _, dof, p, ds = _bwd_ref_common(qkv, do, lse, delta, num_heads, scale)
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    dk = (ds.transpose(-1, -2) @ qs) * (1.0 / _LOG2E)
    flat = lambda t: t.transpose(1, 2).reshape(b, n, -1).to(dt)
    return flat(dk), flat(dv)


def flash_bwd_dq_ref(qkv, do, lse, delta, num_heads: int, scale: float):
    """Plain version of H2's dq kernel -> dq [B, N, H*c]."""
    b, n, _ = qkv.shape
    _, k, _, _, ds = _bwd_ref_common(qkv, do, lse, delta, num_heads, scale)
    dq = (ds @ k) * scale
    return dq.transpose(1, 2).reshape(b, n, -1).to(qkv.dtype)


def flash_self_attention_bwd_ref(qkv, do, lse, delta, num_heads: int,
                                 scale: float) -> torch.Tensor:
    """Plain version of H2: dqkv [B, N, 3*H*c] from (qkv, do, lse, delta)."""
    dk, dv = flash_bwd_dkv_ref(qkv, do, lse, delta, num_heads, scale)
    dq = flash_bwd_dq_ref(qkv, do, lse, delta, num_heads, scale)
    return torch.cat([dq, dk, dv], dim=-1)


def attention_delta(do: torch.Tensor, o: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta[b, h, n] = sum_c do*o in fp32 (the backward's preprocess)."""
    b, n, hc = o.shape
    prod = do.float().reshape(b, n, num_heads, hc // num_heads) * \
        o.float().reshape(b, n, num_heads, hc // num_heads)
    return prod.sum(-1).transpose(1, 2).contiguous()


class FlashSelfAttentionFn(torch.autograd.Function):
    """o = attention(qkv) with the flash kernels: H1 forward, H2 backward
    on CUDA tensors, their plain versions on CPU tensors.

    qkv [B, N, 3*H*c] -> o [B, N, H*c]; saves (qkv, o, lse). The backward
    returns one token-major dqkv that the projection's backward consumes
    directly (the JAX package's ``_flash_tm_qkv``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        if qkv.is_cuda:
            o, lse = flash_self_attention_cuda(qkv, num_heads, scale)
        else:
            o, lse = flash_self_attention_ref(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        h, scale = ctx.num_heads, ctx.scale
        do = do.to(o.dtype).contiguous()
        delta = attention_delta(do, o, h)
        if qkv.is_cuda:
            dqkv = flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale)
        else:
            dqkv = flash_self_attention_bwd_ref(qkv, do, lse, delta, h, scale)
        return dqkv, None, None


def padded_head_dim(c: int) -> int:
    """The head dim the flash path runs at: c itself when a kernel takes it
    or it is a multiple of 32, else c rounded up to a multiple of 32."""
    if c in KERNEL_HEAD_DIMS or c % 32 == 0:
        return c
    return -(-c // 32) * 32


def flash_self_attention(
    x: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    num_heads: int,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused-projection flash self-attention.

    x: [B, N, D] (compute dtype); w_qkv: [3*H*c, D] (nn.Linear layout; rows
    q|k|v, each head-major); b_qkv: [3*H*c]. Returns o [B, N, H*c]
    token-major, the input of the output projection. Differentiable in x,
    w_qkv and b_qkv through ``FlashSelfAttentionFn``. ``kv_mask`` runs only
    grad-free on CPU tensors (the plain version takes it; the kernels take
    no key mask yet).
    """
    b, n, d = x.shape
    hc = w_qkv.shape[0] // 3
    if hc % num_heads:
        raise ValueError(f"qkv width {3 * hc} does not split into {num_heads} heads")
    c = hc // num_heads
    if scale is None:
        scale = c**-0.5
    cp = padded_head_dim(c)
    w, bias = w_qkv, b_qkv
    if cp != c:
        w = F.pad(w_qkv.reshape(3, num_heads, c, d), (0, 0, 0, cp - c))
        w = w.reshape(3 * num_heads * cp, d)
        bias = F.pad(b_qkv.reshape(3, num_heads, c), (0, cp - c)).reshape(-1)
    qkv = _project_qkv(x, w.to(x.dtype), bias)
    if kv_mask is not None:
        if qkv.is_cuda or (torch.is_grad_enabled() and qkv.requires_grad):
            raise NotImplementedError("the flash kernels take no kv_mask yet")
        o, _ = flash_self_attention_ref(qkv, num_heads, scale, kv_mask=kv_mask)
    elif torch.is_grad_enabled() and qkv.requires_grad:
        o = FlashSelfAttentionFn.apply(qkv.contiguous(), num_heads, scale)
    elif qkv.is_cuda:
        o, _ = flash_self_attention_cuda(qkv.contiguous(), num_heads, scale)
    else:
        o, _ = flash_self_attention_ref(qkv, num_heads, scale)
    if cp != c:
        o = o.reshape(b, n, num_heads, cp)[..., :c].reshape(b, n, hc)
    return o
