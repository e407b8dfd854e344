"""The products of a reference: fp32 (the reference), or the control's fp8,
every matmul operand (and, under a gradient, every cotangent) rounded to
float8 e4m3 with one scale per tensor, the products summed in fp32."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the duration (fp32 products stay fp32 on the card)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _e4m3(x: torch.Tensor):
    """(codes, scale): x in float8 e4m3 under one per-tensor scale (amax -> 448)."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn), scale


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale, as fp32."""
    codes, scale = _e4m3(x)
    return codes.float() * scale


class _MM8(torch.autograd.Function):
    """The operands are kept for the backward as their e4m3 codes (a byte an
    element), so that the control fits where the fp32 reference does."""

    @staticmethod
    def forward(ctx, a, b):
        (ca, sa), (cb, sb) = _e4m3(a), _e4m3(b)
        ctx.save_for_backward(ca, sa, cb, sb)
        return torch.matmul(ca.float() * sa, cb.float() * sb)

    @staticmethod
    def backward(ctx, g):
        ca, sa, cb, sb = ctx.saved_tensors
        qa, qb, qg = ca.float() * sa, cb.float() * sb, q8(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        else:
            db = torch.matmul(qa.transpose(-1, -2), qg)
        return da, db


class Numerics:
    """``mm(a, b)``: a [..., M, K] @ b [K, N] or [..., K, N]."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"numerics {kind!r}: 'fp32' or 'fp8'")
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return _MM8.apply(a, b)
        return torch.matmul(a, b)
