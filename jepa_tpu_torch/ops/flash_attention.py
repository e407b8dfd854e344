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

Head dims outside the kernels' {32, 64, 80, 96, 128} that are not multiples
of 32 (the predictors' 24, vit_giant's 88, vit_gigantic's 104) are zero-padded up to the next multiple of 32 in the
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

Key mask (the padded mask mode): an optional ``kv_mask`` [B, N] (True =
valid key) reaches every kernel and plain version; a masked score is set
to -1e30 before the row max (forward) and before exp2(s - lse) (both
backward kernels), as the TPU kernels do, so masked keys get dk = dv = 0.
The pads may sit anywhere in the row (the predictor's mask is
concat(context valid, target valid)). A row with no valid key is out of
scope: the padded mode always keeps a context token.

fp32 (the frozen evals with ``use_bfloat16: false``, serving with
``compute_dtype=torch.float32`` and pretraining with ``meta.dtype:
float32``): a CUDA fp32 qkv launches H1-fp32, the same forward on the CUDA
cores, where every rounding point above is a no-op (fp32 q*(scale*log2e),
fp32 p), with or without a key mask, at head dims 32 (the predictors' 24
padded), 64, 80, 96 (vit_giant) and 128 (vit_gigantic, vit_tiny's 384-wide
predictor) (``F32_HEAD_DIMS``). Its backward is H2-fp32
(``csrc/flash_attention_bwd_f32.cu``: a dq and a dk/dv kernel, masked or
not) at the same head dims (``F32_BWD_HEAD_DIMS``: the predictors' 32,
ViT-L's 64, ViT-H's 80, vit_giant's 96, vit_gigantic's and vit_tiny's
384-wide predictor's 128). An fp32 head dim outside them raises
NotImplementedError on a CUDA tensor; no fp32 call falls back to a plain
version.

Head-major attention (the second half of this module; counterpart of
``flash_attention_bhnd`` / ``flash_attention_packed`` / ``flash_attention``
and their custom_vjps, jepa_tpu/ops/flash_attention.py:122-698): q/k/v
[B, H, N, c] with Nq != Nk allowed, an optional key mask [B, Nk]. On CUDA
tensors the hand-written kernels of ``csrc/flash_attention_hm.cu`` run:
H4 forward (K6), H5 dq (K7), H6 dk/dv (K8) and H7, the merged backward
(K9), which the backward takes exactly where the JAX package takes
``_bwd_merged`` (``merged_bwd``, its ``_merged_fits`` rule). They read
every operand by (b, h, n) strides, so the three planes of a packed
[3, B, H, N, c] qkv, or a permuted view of the token-major projection,
are read with no copy. bf16 with c in {16, 32, 64} (``HM_HEAD_DIMS``);
fp32 (H4-H7-fp32, ``csrc/flash_attention_hm_f32.cu``: the FFMA kernels of
H1-fp32 and H2-fp32 through the same strides) with c in {16, 32, 64}
(``HM_F32_HEAD_DIMS``): vit_tiny's encoder (3 x 64) and its 96-wide
predictor (3 x 32), vit_small's 96-wide predictor (6 x 16); other head
dims and a mix of dtypes raise on CUDA (the plain versions take any).
K6's numerics: row max, p in fp32, the denominator the fp32 sum of the
*unrounded* p, p rounded to bf16 only as the PV operand, o / max(l,
1e-30), lse = m + log2(max(l, 1e-30)); a fully masked row gives the
uniform average.

``flash_self_attention`` routes as the JAX package does
(``self_attention_route``): the token-major H1/H2 where a head split
exists, else the head-major kernels up to N = 2048, else the eager path.

Under remat='attn' (``models.transformer.run_blocks``) every Function here
keeps its forward's (o, lse) across the block's recomputation, and the
token-major route keeps its qkv projection (``ops.remat.keep``), as the
JAX package's selective policy saves the ``optimize_remat`` residuals and
``qkv_out``: the backward launches no second forward kernel.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from jepa_tpu_torch.ops import remat

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (32, 64, 80, 96, 128)
F32_HEAD_DIMS = (32, 64, 80, 96, 128)  # H1-fp32: the predictors' 32, the encoders' 64-128
F32_BWD_HEAD_DIMS = (32, 64, 80, 96, 128)  # H2-fp32: the predictors' 32, the encoders' 64-128
# H4-H7 (bf16) and H4-H7-fp32: vit_tiny's encoder (64) and 96-wide predictor
# (32), vit_small's 96-wide predictor (16)
HM_HEAD_DIMS = (16, 32, 64)
HM_F32_HEAD_DIMS = (16, 32, 64)

# wrapper-counted launches in this process
launches = 0      # H1 (bf16), every head dim, masked or not
launches_by_head_dim = {c: 0 for c in KERNEL_HEAD_DIMS}  # H1 unmasked, per instance
masked_launches_by_head_dim = {c: 0 for c in KERNEL_HEAD_DIMS}  # H1 with a key mask
launches_by_tokens = collections.Counter()  # H1 unmasked, by (head dim, N)
f32_launches_by_head_dim = {c: 0 for c in F32_HEAD_DIMS}  # H1-fp32 unmasked, per instance
f32_masked_launches_by_head_dim = {c: 0 for c in F32_HEAD_DIMS}  # H1-fp32 with a key mask
# H2-fp32 by (kernel "dkv" or "dq", head dim, masked)
f32_bwd_launches = {(k, c, m): 0 for k in ("dkv", "dq") for c in F32_BWD_HEAD_DIMS
                    for m in (False, True)}
dkv_launches = 0  # H2, dk/dv kernel, masked or not
dq_launches = 0   # H2, dq kernel, masked or not
dkv_masked_launches = 0  # of which with a key mask
dq_masked_launches = 0
dkv_launches_by_head_dim = {c: 0 for c in KERNEL_HEAD_DIMS}  # H2 dk/dv, per instance
dq_launches_by_head_dim = {c: 0 for c in KERNEL_HEAD_DIMS}   # H2 dq, per instance
HM_KINDS = ("fwd", "dq", "dkv", "dqkv")  # H4, H5, H6, H7
# H4-H7 and H4-H7-fp32 by (kind, head dim): masked or not, and of which with
# a key mask
hm_launches = {(k, c): 0 for k in HM_KINDS for c in HM_HEAD_DIMS}
hm_masked_launches = dict.fromkeys(hm_launches, 0)
hm_f32_launches = {(k, c): 0 for k in HM_KINDS for c in HM_F32_HEAD_DIMS}
hm_f32_masked_launches = dict.fromkeys(hm_f32_launches, 0)


def reset_launch_counts() -> None:
    global launches, dkv_launches, dq_launches, dkv_masked_launches, dq_masked_launches
    launches = dkv_launches = dq_launches = dkv_masked_launches = dq_masked_launches = 0
    for counts in (launches_by_head_dim, masked_launches_by_head_dim,
                   f32_launches_by_head_dim, f32_masked_launches_by_head_dim,
                   f32_bwd_launches, dkv_launches_by_head_dim,
                   dq_launches_by_head_dim, hm_launches, hm_masked_launches,
                   hm_f32_launches, hm_f32_masked_launches):
        for c in counts:
            counts[c] = 0
    launches_by_tokens.clear()


def _masked_scores(s: torch.Tensor, kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores [B, H, Nq, Nk] with masked keys (kv_mask [B, Nk] False) at -1e30."""
    if kv_mask is None:
        return s
    return torch.where(kv_mask[:, None, None, :].bool(), s,
                       torch.tensor(_NEG_INF, dtype=torch.float32))


def _project_qkv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 keep: bool = False) -> torch.Tensor:
    """x [B, N, D] @ w.T ([3HC, D], nn.Linear layout) + b, fp32 sum, cast to
    x.dtype; ``keep``: kept under remat='attn' (``linear_f32``)."""
    from jepa_tpu_torch.models.transformer import linear_f32

    return linear_f32(x, w, b, x.dtype, keep)


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
    s = _masked_scores(torch.einsum("bqhc,bkhc->bhqk", qs.float(), k.float()), kv_mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m).to(dt)
    l = p.float().sum(dim=-1, keepdim=True)  # [B, H, N, 1]
    o = torch.einsum("bhqk,bkhc->bhqc", p.float(), v.float()) / l
    o = o.to(dt).permute(0, 2, 1, 3).reshape(b, n, hc)
    lse = (m + torch.log2(l)).squeeze(-1)
    return o, lse


def _check_qkv(qkv: torch.Tensor, num_heads: int, name: str,
               dtype: torch.dtype = torch.bfloat16, head_dims=KERNEL_HEAD_DIMS) -> int:
    """Validate a kernel's qkv operand; return its head dim."""
    if not qkv.is_cuda:
        raise ValueError(f"{name}: qkv must be a CUDA tensor")
    if qkv.dtype != dtype:
        raise NotImplementedError(f"{name} takes {dtype} qkv here, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"{name}: bad qkv shape {tuple(qkv.shape)} for "
                         f"{num_heads} heads")
    b, n, w3 = qkv.shape
    c = w3 // (3 * num_heads)
    if c not in head_dims:
        raise NotImplementedError(f"{name}: head dim {c} not in {head_dims}")
    if n < 1 or b < 1:
        raise ValueError(f"{name}: empty input")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    return c


def check_tma_layout(num_heads: int, c: int, elem_bytes: int = 2,
                     name: str = "flash_self_attention_cuda") -> None:
    """Raise unless H1's TMA maps can address qkv [B, N, 3*H*c] and o
    [B, N, H*c]: the qkv row stride (3*H*c elements), each head's column
    offset (h*c; K's and V's at +H*c and +2*H*c) and o's row stride (H*c)
    must be multiples of 16 bytes. Pure integers, so the CPU tests hold
    every shipped call shape against it."""
    for what, nbytes in (("qkv row stride", 3 * num_heads * c * elem_bytes),
                         ("head column offset", c * elem_bytes),
                         ("o row stride", num_heads * c * elem_bytes)):
        if nbytes % 16:
            raise ValueError(f"{name}: the {what} ({nbytes} bytes at H={num_heads}, c={c}) "
                             "is not a multiple of 16 bytes, as TMA needs")


def _hm_tma_fault(ptr: int, strides, elem_bytes: int = 2) -> str:
    """What keeps H4's 4-D TMA map (C, N, H, B) from addressing one
    head-major operand, or '' if nothing: its base and its (batch, head,
    row) strides, in elements, must be multiples of 16 bytes, positive
    and below 2^31 elements."""
    if ptr % 16:
        return f"a base address {ptr:#x} that is not 16-byte aligned"
    for what, st in zip(("batch", "head", "row"), strides):
        if (st * elem_bytes) % 16 or not 0 < st < 2**31:
            return f"a {what} stride of {st} elements ({st * elem_bytes} bytes)"
    return ""


def check_hm_tma_layout(ptr: int, strides, elem_bytes: int = 2,
                        name: str = "flash_attention_hm_cuda") -> None:
    """Raise unless H4's TMA maps can address a head-major [B, H, N, c]
    operand with a contiguous head dim, its base at ``ptr`` and its
    (batch, head, row) ``strides`` in elements: the base and each stride
    must be a positive multiple of 16 bytes. Pure integers, so the CPU
    tests hold the routes' strided operands against it."""
    fault = _hm_tma_fault(ptr, strides, elem_bytes)
    if fault:
        raise ValueError(f"{name}: an operand has {fault}, and TMA needs multiples of 16 bytes")


def _kernel_mask(kv_mask: Optional[torch.Tensor], qkv: torch.Tensor, name: str):
    """The kernels' key-mask operand: kv_mask [B, N] (bool or 0/1) as a
    contiguous uint8 tensor on qkv's device, or None."""
    if kv_mask is None:
        return None
    b, n, _ = qkv.shape
    if tuple(kv_mask.shape) != (b, n) or kv_mask.device != qkv.device:
        raise ValueError(f"{name}: kv_mask must be [B, N] = {(b, n)} on {qkv.device}, "
                         f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
    return kv_mask.to(torch.uint8).contiguous()


def flash_self_attention_cuda(
    qkv: torch.Tensor, num_heads: int, scale: float,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch H1 on qkv's current stream. qkv [B, N, 3*H*c]: bf16 with c in
    {32, 64, 80, 96, 128}, or fp32 (H1-fp32) with c in {32, 64, 80, 96,
    128}; kv_mask [B, N] (True = valid key) or None in both. Differentiable
    only through ``FlashSelfAttentionFn``, whose backward takes both at
    every head dim here (H2, H2-fp32)."""
    global launches
    from jepa_tpu_torch.ops._build import check, load_library

    name = "flash_self_attention_cuda"
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError(f"{name} has no autograd of its own; use "
                                  "FlashSelfAttentionFn")
    qscale = float(scale) * _LOG2E
    if qkv.dtype == torch.float32:
        c = _check_qkv(qkv, num_heads, name, torch.float32, F32_HEAD_DIMS)
        mask = _kernel_mask(kv_mask, qkv, name)
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        b, n, _ = qkv.shape
        o = torch.empty((b, n, num_heads * c), dtype=qkv.dtype, device=qkv.device)
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
        entry = f"jt_flash_fwd_f32_c{c}"
        check(getattr(load_library(), entry)(
            qkv.data_ptr(), None if mask is None else mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, num_heads, qscale, stream), entry)
        (f32_launches_by_head_dim if mask is None else f32_masked_launches_by_head_dim)[c] += 1
        return o, lse
    c = _check_qkv(qkv, num_heads, name)
    check_tma_layout(num_heads, c, qkv.element_size(), name)
    mask = _kernel_mask(kv_mask, qkv, name)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    b, n, _ = qkv.shape
    o = torch.empty((b, n, num_heads * c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    entry = f"jt_flash_fwd_c{c}"
    check(getattr(load_library(), entry)(
        qkv.data_ptr(), None if mask is None else mask.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, n, num_heads, qscale, stream), entry)
    launches += 1
    (launches_by_head_dim if mask is None else masked_launches_by_head_dim)[c] += 1
    if mask is None:
        launches_by_tokens[c, n] += 1
    return o, lse


def _launch_bwd(kind: str, qkv, do, lse, delta, dqkv, num_heads: int,
                scale: float, kv_mask=None) -> None:
    """Check the operands of one H2 kernel (``kind`` "dkv" or "dq"; H2-fp32
    for an fp32 qkv) and launch it on qkv's current stream."""
    global dkv_launches, dq_launches, dkv_masked_launches, dq_masked_launches
    from jepa_tpu_torch.ops._build import check, load_library

    name = f"flash_bwd_{kind}_cuda"
    f32 = qkv.dtype == torch.float32
    c = (_check_qkv(qkv, num_heads, name, torch.float32, F32_BWD_HEAD_DIMS) if f32
         else _check_qkv(qkv, num_heads, name))
    mask = _kernel_mask(kv_mask, qkv, name)
    b, n, _ = qkv.shape
    hc = num_heads * c
    if do.dtype != qkv.dtype or tuple(do.shape) != (b, n, hc) or not do.is_contiguous():
        raise ValueError(f"{name}: do must be contiguous {qkv.dtype} [B, N, H*c]")
    for t, label in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, num_heads, n)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be contiguous fp32 [B, H, N]")
    if do.data_ptr() % 16 or dqkv.data_ptr() % 16:
        raise ValueError(f"{name}: do and dqkv must be 16-byte aligned")
    if not f32:  # H2's TMA maps; H2-fp32 reads and writes float4s (rows of c*4 bytes)
        check_tma_layout(num_heads, c, qkv.element_size(), name)
    if dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype or not dqkv.is_contiguous():
        raise ValueError(f"{name}: dqkv must be shaped like qkv")
    entry = f"jt_flash_bwd_{kind}_f32_c{c}" if f32 else f"jt_flash_bwd_{kind}_c{c}"
    extra = (float(scale),) if kind == "dq" else ()  # dq's accumulator scale
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    check(getattr(load_library(), entry)(
        qkv.data_ptr(), None if mask is None else mask.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, n, num_heads,
        float(scale) * _LOG2E, *extra, stream), entry)
    if f32:
        f32_bwd_launches[kind, c, mask is not None] += 1
    elif kind == "dq":
        dq_launches += 1
        dq_masked_launches += mask is not None
        dq_launches_by_head_dim[c] += 1
    else:
        dkv_launches += 1
        dkv_masked_launches += mask is not None
        dkv_launches_by_head_dim[c] += 1


def flash_bwd_dkv_cuda(qkv, do, lse, delta, dqkv, num_heads: int, scale: float,
                       kv_mask=None) -> None:
    """Launch H2's dk/dv kernel (H2-fp32's for fp32): writes dk and dv into
    columns [H*c, 3*H*c) of dqkv [B, N, 3*H*c]; masked keys get exactly 0."""
    _launch_bwd("dkv", qkv, do, lse, delta, dqkv, num_heads, scale, kv_mask)


def flash_bwd_dq_cuda(qkv, do, lse, delta, dqkv, num_heads: int, scale: float,
                      kv_mask=None) -> None:
    """Launch H2's dq kernel: writes dq into columns [0, H*c) of dqkv."""
    _launch_bwd("dq", qkv, do, lse, delta, dqkv, num_heads, scale, kv_mask)


def flash_self_attention_bwd_cuda(qkv, do, lse, delta, num_heads: int,
                                  scale: float, kv_mask=None) -> torch.Tensor:
    """H2 (H2-fp32 for fp32): both backward kernels into one token-major
    dqkv [B, N, 3*H*c]."""
    dqkv = torch.empty_like(qkv)
    flash_bwd_dkv_cuda(qkv, do, lse, delta, dqkv, num_heads, scale, kv_mask)
    flash_bwd_dq_cuda(qkv, do, lse, delta, dqkv, num_heads, scale, kv_mask)
    return dqkv


def _bwd_ref_common(qkv, do, lse, delta, num_heads, scale, kv_mask=None):
    """Shared recompute of the plain backward: (q scaled, k, v, do, p, ds),
    head-major fp32 except where a bf16 rounding point is kept."""
    b, n, w3 = qkv.shape
    c = w3 // (3 * num_heads)
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, n, 3, num_heads, c).permute(2, 0, 3, 1, 4).unbind(0)
    qs = (q.float() * (scale * _LOG2E)).to(dt).float()          # [B, H, N, c]
    dof = do.reshape(b, n, num_heads, c).transpose(1, 2).float()
    s = _masked_scores(qs @ k.float().transpose(-1, -2), kv_mask)  # [B, H, N, N]
    p = torch.exp2(s - lse[..., None])
    dp = dof @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    return qs, k.float(), dof, p, ds


def flash_bwd_dkv_ref(qkv, do, lse, delta, num_heads: int, scale: float, kv_mask=None):
    """Plain version of H2's dk/dv kernel -> (dk, dv), each [B, N, H*c]."""
    b, n, _ = qkv.shape
    dt = qkv.dtype
    qs, _, dof, p, ds = _bwd_ref_common(qkv, do, lse, delta, num_heads, scale, kv_mask)
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    dk = (ds.transpose(-1, -2) @ qs) * (1.0 / _LOG2E)
    flat = lambda t: t.transpose(1, 2).reshape(b, n, -1).to(dt)
    return flat(dk), flat(dv)


def flash_bwd_dq_ref(qkv, do, lse, delta, num_heads: int, scale: float, kv_mask=None):
    """Plain version of H2's dq kernel -> dq [B, N, H*c]."""
    b, n, _ = qkv.shape
    _, k, _, _, ds = _bwd_ref_common(qkv, do, lse, delta, num_heads, scale, kv_mask)
    dq = (ds @ k) * scale
    return dq.transpose(1, 2).reshape(b, n, -1).to(qkv.dtype)


def flash_self_attention_bwd_ref(qkv, do, lse, delta, num_heads: int,
                                 scale: float, kv_mask=None) -> torch.Tensor:
    """Plain version of H2: dqkv [B, N, 3*H*c] from (qkv, do, lse, delta)."""
    dk, dv = flash_bwd_dkv_ref(qkv, do, lse, delta, num_heads, scale, kv_mask)
    dq = flash_bwd_dq_ref(qkv, do, lse, delta, num_heads, scale, kv_mask)
    return torch.cat([dq, dk, dv], dim=-1)


def attention_delta(do: torch.Tensor, o: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta[b, h, n] = sum_c do*o in fp32 (the backward's preprocess)."""
    b, n, hc = o.shape
    prod = do.float().reshape(b, n, num_heads, hc // num_heads) * \
        o.float().reshape(b, n, num_heads, hc // num_heads)
    return prod.sum(-1).transpose(1, 2).contiguous()


class FlashSelfAttentionFn(torch.autograd.Function):
    """o = attention(qkv) with the flash kernels: H1 forward, H2 backward
    (H1-fp32 and H2-fp32 for fp32) on CUDA tensors, their plain versions on
    CPU tensors.

    qkv [B, N, 3*H*c] -> o [B, N, H*c], with an optional key mask
    kv_mask [B, N]; saves (qkv, o, lse, kv_mask). The backward returns one
    token-major dqkv that the projection's backward consumes directly (the
    JAX package's ``_flash_tm_qkv`` and ``_flash_tm_qkv_masked``); the
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, kv_mask=None):
        fwd = flash_self_attention_cuda if qkv.is_cuda else flash_self_attention_ref
        o, lse = remat.keep(lambda: fwd(qkv, num_heads, scale, kv_mask))
        ctx.save_for_backward(qkv, o, lse, kv_mask)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, kv_mask = ctx.saved_tensors
        h, scale = ctx.num_heads, ctx.scale
        do = do.to(o.dtype).contiguous()
        delta = attention_delta(do, o, h)
        if qkv.is_cuda:
            dqkv = flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, kv_mask)
        else:
            dqkv = flash_self_attention_bwd_ref(qkv, do, lse, delta, h, scale, kv_mask)
        return dqkv, None, None, None


def padded_head_dim(c: int) -> int:
    """The head dim the token-major path runs at: c itself when a kernel
    takes it or it is a multiple of 32, else c rounded up to a multiple of 32."""
    if c in KERNEL_HEAD_DIMS or c % 32 == 0:
        return c
    return -(-c // 32) * 32


# ---- the JAX package's dispatch rules, as pure integer functions ------------
# (jepa_tpu/ops/flash_attention.py:66-107, 422-429, 736-751, 1776-1803)

_BWD_TEMP_BUDGET = 11 * 2**20 + 2**19
_MAX_NK = 8192          # beyond this the head-major entries run xla_attention
_PACKED_SAFE_N = 2048   # beyond this flash_self_attention's head-major route runs eager
_TM_MAX_UNROLLED_HEADS = 8
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_block(n: int, other_len: int, budget: int, requested: int) -> int:
    """The JAX package's block size for an axis of length n (the largest
    8-multiple divisor of the 128-rounded n that fits the budget)."""
    n128, other_pad = _round_up(n, 128), _round_up(other_len, 128)
    fits = lambda blk: blk * other_pad * 16 <= budget
    for k in range(1, 65):
        if n128 % k == 0:
            blk = n128 // k
            if blk % 8 == 0 and blk <= requested and (fits(blk) or blk == 128):
                return blk
    blk = max(128, (requested // 128) * 128)
    while blk > 128 and not fits(blk):
        blk //= 2
    return blk


def _merged_fits(nq: int, nk: int, d: int, block_k: int) -> bool:
    """The JAX package's test for its merged head-major backward (K9)."""
    nq_pad, d_pad = _round_up(nq, 128), _round_up(d, 128)
    return block_k * nq_pad * 14 + nq_pad * d_pad * 12 <= _BWD_TEMP_BUDGET


def merged_bwd(nq: int, nk: int, c: int, block_k: int = DEFAULT_BLOCK_K) -> bool:
    """Does the head-major backward run the merged kernel H7 (else H5 + H6)?
    Exactly where the JAX package runs ``_bwd_merged``."""
    return _merged_fits(nq, nk, c, _pick_block(nk, nq, _BWD_TEMP_BUDGET, block_k))


def _tm_split_exists(heads: int, c: int) -> bool:
    """A token-major head split: s | heads with (heads*c/s) % 128 == 0 and
    at most 8 heads per group (the split test of ``_pick_tm_params``)."""
    return any(heads % s == 0 and (heads * c // s) % 128 == 0
               and heads // s <= _TM_MAX_UNROLLED_HEADS for s in range(1, heads + 1))


def self_attention_route(heads: int, c: int, n: int) -> str:
    """Where ``flash_self_attention`` runs: 'tm' (H1/H2 over the fused qkv,
    the head dim zero-padded to a multiple of 32 where that makes a split),
    'hm' (the head-major kernels over the packed planes) or 'eager'
    (``xla_attention``), the JAX package's answer on every factory geometry
    (tests/test_torch_flash_attention_hm.py holds it against the pickers)."""
    cp = c if _tm_split_exists(heads, c) or c % 32 == 0 else _round_up(c, 32)
    if n <= _MAX_NK and _tm_split_exists(heads, cp):
        return "tm"
    return "eager" if n > _PACKED_SAFE_N else "hm"


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
    w_qkv and b_qkv. ``kv_mask`` [B, N] (True = valid key) reaches the
    kernels and the plain versions alike. The route (``self_attention_route``)
    is the JAX package's: 'tm' runs ``FlashSelfAttentionFn``; 'hm' runs
    ``flash_attention_packed`` on a [3, B, H, N, c] view of the projection
    (no copy: the kernels read it by stride and write o token-major);
    'eager' runs ``xla_attention``.
    """
    b, n, d = x.shape
    hc = w_qkv.shape[0] // 3
    if hc % num_heads:
        raise ValueError(f"qkv width {3 * hc} does not split into {num_heads} heads")
    c = hc // num_heads
    if scale is None:
        scale = c**-0.5
    route = self_attention_route(num_heads, c, n)
    if route != "tm":
        qkv = _project_qkv(x, w_qkv.to(x.dtype), b_qkv).view(b, n, 3, num_heads, c)
        if route == "eager":
            from jepa_tpu_torch.ops.attention import xla_attention

            q, k, v = qkv.unbind(2)
            return xla_attention(q, k, v, kv_mask=kv_mask, scale=scale).reshape(b, n, hc)
        o = flash_attention_packed(qkv.permute(2, 0, 3, 1, 4), kv_mask=kv_mask, scale=scale)
        return o.transpose(1, 2).reshape(b, n, hc)
    cp = padded_head_dim(c)
    w, bias = w_qkv, b_qkv
    if cp != c:
        w = F.pad(w_qkv.reshape(3, num_heads, c, d), (0, 0, 0, cp - c))
        w = w.reshape(3 * num_heads * cp, d)
        bias = F.pad(b_qkv.reshape(3, num_heads, c), (0, cp - c)).reshape(-1)
    qkv = _project_qkv(x, w.to(x.dtype), bias, keep=True)  # the JAX package's "qkv_out"
    if torch.is_grad_enabled() and qkv.requires_grad:
        o = FlashSelfAttentionFn.apply(qkv.contiguous(), num_heads, scale, kv_mask)
    elif qkv.is_cuda:
        o, _ = flash_self_attention_cuda(qkv.contiguous(), num_heads, scale, kv_mask)
    else:
        o, _ = flash_self_attention_ref(qkv, num_heads, scale, kv_mask)
    if cp != c:
        o = o.reshape(b, n, num_heads, cp)[..., :c].reshape(b, n, hc)
    return o


# ---- head-major attention: plain versions ------------------------------------


def _hm_scores(q, k, scale, kv_mask):
    """(q*(scale*log2e) rounded to q's dtype, as fp32; base-2 scores
    [B, H, Nq, Nk] fp32 with masked keys at -1e30)."""
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype).float()
    return qs, _masked_scores(qs @ k.float().transpose(-1, -2), kv_mask)


def _into(out, values):
    """Copy ``values`` into the tensors ``out`` (when given) and return them."""
    if out is None:
        return values
    for dst, src in zip(out, values):
        dst.copy_(src)
    return tuple(out)


def flash_fwd_hm_ref(q, k, v, scale: float, kv_mask=None):
    """Plain version of H4 (K6): q [B, H, Nq, c], k/v [B, H, Nk, c] ->
    (o [B, H, Nq, c] in q's dtype, lse [B, H, Nq] fp32 base 2). The
    denominator is the fp32 sum of the unrounded p, clamped at 1e-30."""
    _, s = _hm_scores(q, k, scale, kv_mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(q.dtype).float() @ v.float()) / l
    return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _hm_bwd_common(q, k, v, do, lse, delta, scale, kv_mask):
    """(q scaled, p fp32, ds rounded to q's dtype) of the head-major backward."""
    qs, s = _hm_scores(q, k, scale, kv_mask)
    p = torch.exp2(s - lse[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return qs, p, ds


def flash_bwd_dq_hm_ref(q, k, v, do, lse, delta, scale: float, kv_mask=None, out=None):
    """Plain version of H5 (K7): dq [B, H, Nq, c]."""
    _, _, ds = _hm_bwd_common(q, k, v, do, lse, delta, scale, kv_mask)
    dq = ((ds @ k.float()) * scale).to(q.dtype)
    return dq if out is None else _into((out,), (dq,))[0]


def flash_bwd_dkv_hm_ref(q, k, v, do, lse, delta, scale: float, kv_mask=None, out=None):
    """Plain version of H6 (K8): (dk, dv) [B, H, Nk, c]; masked keys get 0."""
    qs, p, ds = _hm_bwd_common(q, k, v, do, lse, delta, scale, kv_mask)
    dv = p.to(q.dtype).float().transpose(-1, -2) @ do.float()
    dk = (ds.transpose(-1, -2) @ qs) * (1.0 / _LOG2E)
    return _into(out, (dk.to(q.dtype), dv.to(q.dtype)))


def flash_bwd_dqkv_hm_ref(q, k, v, do, lse, delta, scale: float, kv_mask=None, out=None):
    """Plain version of H7 (K9): (dq, dk, dv), by construction the numbers
    of H5 and H6."""
    qs, p, ds = _hm_bwd_common(q, k, v, do, lse, delta, scale, kv_mask)
    dq = (ds @ k.float()) * scale
    dv = p.to(q.dtype).float().transpose(-1, -2) @ do.float()
    dk = (ds.transpose(-1, -2) @ qs) * (1.0 / _LOG2E)
    return _into(out, tuple(t.to(q.dtype) for t in (dq, dk, dv)))


def hm_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta[b, h, n] = sum_c do*o in fp32, contiguous (the backward's preprocess)."""
    return (do.float() * o.float()).sum(-1).contiguous()


# ---- head-major attention: the CUDA kernels (csrc/flash_attention_hm.cu) -------


_HM_STRIDED = ("q", "k", "v", "o", "do", "dq", "dk", "dv")  # the [B, H, N, c] operands


class _HmArgs(ctypes.Structure):
    """The C struct HmArgs of csrc/flash_attention_hm.cu, field for field.
    Strides are (batch, head, row) in elements; the head dim is contiguous."""
    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("q", "k", "v", "kvm", "o", "do", "lse", "delta", "dq", "dk", "dv", "ws")]
                + [(f, ctypes.c_int) for f in ("B", "H", "Nq", "Nk")]
                + [(f"{f}_s", ctypes.c_int * 3) for f in _HM_STRIDED]
                + [("qscale", ctypes.c_float), ("scale", ctypes.c_float)])


def _alloc_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised dense tensor shaped like t whose dims are laid out
    in t's stride order (so an output shaped [B, H, N, c] of a token-major
    input comes out token-major, and its transpose back is free)."""
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    buf = torch.empty([t.shape[i] for i in order], dtype=t.dtype, device=t.device)
    return buf.permute([order.index(i) for i in range(t.dim())])


def _hm_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it by stride (a contiguous head
    dim, the rest as TMA needs it: ``check_hm_tma_layout``), else a
    contiguous copy."""
    ok = t.stride(-1) == 1 and not _hm_tma_fault(t.data_ptr(), t.stride()[:-1], t.element_size())
    return t if ok else t.contiguous()


def hm_slab_keys(dtype: torch.dtype) -> int:
    """Keys per k-block of the merged backward's dq workspace: H7's 64
    (one consumer warpgroup's kv rows), H7-fp32's 128 (one block's)."""
    return 128 if dtype == torch.float32 else 64


def _check_hm(name: str, q, k, v, kv_mask, ops: dict):
    """Validate the head-major kernels' operands: q, k, v and the named
    [B, H, N, c] operands ``ops`` CUDA tensors of one dtype, bf16 (H4-H7,
    c in ``HM_HEAD_DIMS``) or fp32 (H4-H7-fp32, c in ``HM_F32_HEAD_DIMS``),
    of matching shapes with a contiguous head dim, laid out as TMA and the
    fp32 kernels' 16-byte copies need (``check_hm_tma_layout``); lse and
    delta contiguous fp32 [B, H, Nq]; the workspace contiguous fp32
    [ceil(Nk / hm_slab_keys), B, H, Nq, c].
    Returns (B, H, Nq, Nk, c, the uint8 key mask or None)."""
    b, h, nq, c = q.shape if q.dim() == 4 else (0,) * 4
    nk = k.shape[2] if k.dim() == 4 else 0
    shapes = dict(q=(b, h, nq, c), k=(b, h, nk, c), v=(b, h, nk, c), o=(b, h, nq, c),
                  do=(b, h, nq, c), dq=(b, h, nq, c), dk=(b, h, nk, c), dv=(b, h, nk, c))
    dims = {torch.bfloat16: HM_HEAD_DIMS, torch.float32: HM_F32_HEAD_DIMS}
    named = dict(q=q, k=k, v=v, **ops)
    for n, t in named.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: operands must be CUDA tensors")
        if n in _HM_STRIDED and t.dtype != q.dtype:
            raise ValueError(f"{name}: {n} is {t.dtype} and q {q.dtype}; the operands "
                             "must share one dtype")
    if q.dtype not in dims:
        raise NotImplementedError(f"{name} takes bf16 or fp32 operands, got {q.dtype}")
    if c not in dims[q.dtype]:
        raise NotImplementedError(f"{name}: head dim {c} not in {dims[q.dtype]} for {q.dtype}")
    ws_rows = -(-nk // hm_slab_keys(q.dtype))
    for n, t in named.items():
        if n in _HM_STRIDED:
            if tuple(t.shape) != shapes[n] or t.stride(-1) != 1:
                raise ValueError(f"{name}: {n} must be {shapes[n]} = [B, H, N, c] with a "
                                 f"contiguous head dim")
            check_hm_tma_layout(t.data_ptr(), t.stride()[:-1], t.element_size(), f"{name}: {n}")
        elif (t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != (
                (ws_rows, b, h, nq, c) if n == "ws" else (b, h, nq))):
            raise ValueError(f"{name}: {n} must be contiguous fp32 "
                             f"{'[ceil(Nk/slab keys), B, H, Nq, c]' if n == 'ws' else '[B, H, Nq]'}")
    if min(b, h, nq, nk) < 1:
        raise ValueError(f"{name}: empty input")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, nk) or kv_mask.device != q.device:
            raise ValueError(f"{name}: kv_mask must be [B, Nk] = {(b, nk)} on {q.device}")
        mask = kv_mask.to(torch.uint8).contiguous()
    return b, h, nq, nk, c, mask


def _launch_hm(kind: str, q, k, v, scale: float, kv_mask, **ops) -> None:
    """Fill HmArgs from q, k, v, the mask and the named operands ``ops``
    (o, do, lse, delta, dq, dk, dv, ws) and launch the H4-H7 entry ``kind``
    (H4-H7-fp32's for fp32 operands) on q's current stream."""
    from jepa_tpu_torch.ops._build import check, load_library

    name = f"flash_hm_{kind}_cuda"
    b, h, nq, nk, c, mask = _check_hm(name, q, k, v, kv_mask, ops)
    a = _HmArgs(B=b, H=h, Nq=nq, Nk=nk, qscale=float(scale) * _LOG2E, scale=float(scale))
    for n, t in dict(q=q, k=k, v=v, kvm=mask, **ops).items():
        if t is not None:
            setattr(a, n, t.data_ptr())
            if n in _HM_STRIDED:
                setattr(a, f"{n}_s", (ctypes.c_int * 3)(*t.stride()[:3]))
    f32 = q.dtype == torch.float32
    entry = f"jt_flash_hm_{kind}{'_f32' if f32 else ''}_c{c}"
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(getattr(load_library(), entry)(ctypes.addressof(a), stream), entry)
    if f32:
        hm_f32_launches[kind, c] += 1
        hm_f32_masked_launches[kind, c] += mask is not None
    else:
        hm_launches[kind, c] += 1
        hm_masked_launches[kind, c] += mask is not None


def flash_fwd_hm_cuda(q, k, v, scale: float, kv_mask=None):
    """Launch H4 (K6): (o [B, H, Nq, c] laid out like q, lse [B, H, Nq] fp32)."""
    o = _alloc_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch_hm("fwd", q, k, v, scale, kv_mask, o=o, lse=lse)
    return o, lse


def flash_bwd_dq_hm_cuda(q, k, v, do, lse, delta, scale: float, kv_mask=None, out=None):
    """Launch H5 (K7): dq [B, H, Nq, c] (into ``out`` when given)."""
    dq = _alloc_like(q) if out is None else out
    _launch_hm("dq", q, k, v, scale, kv_mask, do=do, lse=lse, delta=delta, dq=dq)
    return dq


def flash_bwd_dkv_hm_cuda(q, k, v, do, lse, delta, scale: float, kv_mask=None, out=None):
    """Launch H6 (K8): (dk, dv) [B, H, Nk, c] (into ``out`` when given);
    masked keys get exactly 0."""
    dk, dv = (_alloc_like(k), _alloc_like(v)) if out is None else out
    _launch_hm("dkv", q, k, v, scale, kv_mask, do=do, lse=lse, delta=delta, dk=dk, dv=dv)
    return dk, dv


def flash_bwd_dqkv_hm_cuda(q, k, v, do, lse, delta, scale: float, kv_mask=None, out=None):
    """Launch H7 (K9; H7-fp32 for fp32), the merged backward: (dq, dk, dv)
    (into ``out`` when given). Each k-block of ``hm_slab_keys`` keys (64 in
    bf16, 128 in fp32) stores its fp32 dq partial in its own slab of a
    workspace [ceil(Nk / slab keys), B, H, Nq, c]; the same entry then sums
    the slabs in block order (deterministic), scales and casts."""
    dq, dk, dv = (_alloc_like(q), _alloc_like(k), _alloc_like(v)) if out is None else out
    ws = torch.empty((-(-k.shape[2] // hm_slab_keys(q.dtype)), *q.shape), dtype=torch.float32,
                     device=q.device)
    _launch_hm("dqkv", q, k, v, scale, kv_mask, do=do, lse=lse, delta=delta, dq=dq, dk=dk,
               dv=dv, ws=ws)
    return dq, dk, dv


# ---- head-major attention: autograd and the public entries --------------------


def _hm_forward(q, k, v, scale, kv_mask):
    if q.is_cuda:
        q, k, v = map(_hm_operand, (q, k, v))
        return flash_fwd_hm_cuda(q, k, v, scale, kv_mask)
    return flash_fwd_hm_ref(q, k, v, scale, kv_mask)


def _hm_backward(q, k, v, o, lse, do, scale, kv_mask, block_k, out):
    """dq, dk, dv into ``out``: the merged H7 where the JAX package runs
    ``_bwd_merged``, else H5 then H6 (their plain versions on the CPU)."""
    delta = hm_delta(do, o)
    if q.is_cuda:
        q, k, v, do = map(_hm_operand, (q, k, v, do))
    cuda = q.is_cuda
    if merged_bwd(q.shape[2], k.shape[2], q.shape[3], block_k):
        fn = flash_bwd_dqkv_hm_cuda if cuda else flash_bwd_dqkv_hm_ref
        fn(q, k, v, do, lse, delta, scale, kv_mask, out=out)
        return
    (flash_bwd_dq_hm_cuda if cuda else flash_bwd_dq_hm_ref)(
        q, k, v, do, lse, delta, scale, kv_mask, out=out[0])
    (flash_bwd_dkv_hm_cuda if cuda else flash_bwd_dkv_hm_ref)(
        q, k, v, do, lse, delta, scale, kv_mask, out=out[1:])


class FlashAttentionHmFn(torch.autograd.Function):
    """o = attention(q, k, v), head-major [B, H, N, c] (the JAX package's
    ``_flash_nomask`` / ``_flash_masked``): saves (q, k, v, o, lse, mask);
    the mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, block_k):
        o, lse = remat.keep(lambda: _hm_forward(q, k, v, scale, kv_mask))
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.scale, ctx.block_k = scale, block_k
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        out = (_alloc_like(q), _alloc_like(k), _alloc_like(v))
        _hm_backward(q, k, v, o, lse, do.to(o.dtype), ctx.scale, kv_mask, ctx.block_k, out)
        return (*out, None, None, None)


class FlashAttentionPackedFn(torch.autograd.Function):
    """o = attention over a packed qkv [3, B, H, N, c] (the JAX package's
    ``_flash_packed`` / ``_flash_packed_masked``): the kernels read the three
    planes in place and write dq, dk, dv into the planes of one dqkv laid
    out like qkv."""

    @staticmethod
    def forward(ctx, qkv, kv_mask, scale, block_k):
        o, lse = remat.keep(lambda: _hm_forward(*qkv.unbind(0), scale, kv_mask))
        ctx.save_for_backward(qkv, o, lse, kv_mask)
        ctx.scale, ctx.block_k = scale, block_k
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, kv_mask = ctx.saved_tensors
        dqkv = _alloc_like(qkv)
        _hm_backward(*qkv.unbind(0), o, lse, do.to(o.dtype), ctx.scale, kv_mask,
                     ctx.block_k, dqkv.unbind(0))
        return dqkv, None, None, None


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _xla_bhnd(q, k, v, kv_mask, scale):
    """xla_attention on head-major operands (sequences past ``_MAX_NK``)."""
    from jepa_tpu_torch.ops.attention import xla_attention

    t = lambda a: a.transpose(1, 2)
    return t(xla_attention(t(q), t(k), t(v), kv_mask=kv_mask, scale=scale))


def flash_attention_packed(
    qkv: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Flash self-attention over a packed qkv [3, B, H, N, c] (any strides
    with a contiguous head dim). Returns o [B, H, N, c]. ``block_q`` is kept
    for the JAX signature; ``block_k`` enters the merged-backward rule."""
    _, b, h, n, c = qkv.shape
    if scale is None:
        scale = c**-0.5
    if n > _MAX_NK:
        return _xla_bhnd(*qkv.unbind(0), kv_mask, scale)
    if _wants_grad(qkv):
        return FlashAttentionPackedFn.apply(qkv, kv_mask, scale, block_k)
    return _hm_forward(*qkv.unbind(0), scale, kv_mask)[0]


def flash_attention_bhnd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Flash attention on head-major operands: q [B, H, Nq, c], k/v
    [B, H, Nk, c], kv_mask [B, Nk] bool (True = valid key). Returns
    [B, H, Nq, c] in q's dtype, differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape[2] > _MAX_NK:
        return _xla_bhnd(q, k, v, kv_mask, scale)
    if _wants_grad(q, k, v):
        return FlashAttentionHmFn.apply(q, k, v, kv_mask, scale, block_k)
    return _hm_forward(q, k, v, scale, kv_mask)[0]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Flash attention, token-major: q [B, Nq, H, c], k/v [B, Nk, H, c] ->
    [B, Nq, H, c]. The head-major kernels read the transposed views by
    stride, so no copy is made."""
    o = flash_attention_bhnd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             kv_mask=kv_mask, scale=scale, block_q=block_q, block_k=block_k)
    return o.transpose(1, 2)
