"""Fused fc1 matmul + bias + GELU (counterpart of jepa_tpu/ops/fused_mlp.py).

``linear_gelu`` is the MLP's first layer on grad-free forwards. For a CUDA
tensor it launches a hand-written Hopper kernel from ``csrc/fused_mlp.cu``:
H3 for bf16 (tensor cores), H3-fp32 for fp32 (CUDA-core FFMA; the frozen
evals with ``use_bfloat16: false``). For a CPU tensor it runs
``linear_gelu_ref``, the plain PyTorch version of the same math. Weights
keep the ``nn.Linear`` layout [F, K].

Numerics, as the JAX package: fp32 accumulation, the bias added in fp32,
z rounded to the compute dtype before the activation, then the exp2-erfc
polynomial GELU (``_gelu_fast``) for bf16 outputs and the A&S 7.1.26 erf
GELU (``_gelu``) for fp32 outputs. Shapes outside the kernel's tiling
(jepa_tpu/ops/fused_mlp.py:277) take the plain exact-erf path in both
packages.
"""

from __future__ import annotations

import torch

_INV_SQRT2 = 0.7071067811865476
_LN2 = 0.6931471805599453
_ERF_G = (1.6279511504838011, 0.9179117972647749, 0.15048427545502158,
          -0.03191463214715457, 0.004236621237891429, -0.00025575246004894803)

_KERNEL_K_STEP = {torch.bfloat16: 32, torch.float32: 16}  # each kernel's k panel

# wrapper-counted launches in this process
launches = 0      # H3 (bf16)
f32_launches = 0  # H3-fp32


def _erf(x: torch.Tensor) -> torch.Tensor:
    """fp32 erf via Abramowitz-Stegun 7.1.26 (|eps| <= 1.5e-7), the JAX
    package's in-kernel erf (jepa_tpu/ops/fused_mlp.py:36)."""
    a1, a2, a3, a4, a5 = (
        0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    )
    p = 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * torch.exp(-ax * ax)
    return torch.sign(x) * y


def _gelu(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * z * (1.0 + _erf(z * _INV_SQRT2))


def _gelu_fast(z: torch.Tensor) -> torch.Tensor:
    """bf16-output GELU via erfc(x) ~= exp2(-g(|x|)), g a degree-6
    polynomial clamped at 3.9 (jepa_tpu/ops/fused_mlp.py:65-74)."""
    ax = torch.clamp(z.abs() * _INV_SQRT2, max=3.9)
    c1, c2, c3, c4, c5, c6 = _ERF_G
    g = ax * (c1 + ax * (c2 + ax * (c3 + ax * (c4 + ax * (c5 + ax * c6)))))
    e = torch.exp2(-g)  # erfc(|z|/sqrt2)
    return 0.5 * z * torch.where(z >= 0, 2.0 - e, e)


class GeluFast(torch.autograd.Function):
    """``_gelu_fast`` of a compute-dtype tensor with its derivative written
    out, so that a training forward keeps only its input for the backward
    (autograd through the eager formula keeps about ten fp32 copies of the
    [tokens, 4*D] activation). The backward is the exact derivative of the
    same formula: d/dz 0.5*z*sel(z) = 0.5*sel + 0.5*z*ln2/sqrt2*g'(a)*e,
    with a = min(|z|/sqrt2, 3.9) and no slope past the clamp."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return _gelu_fast(h.float()).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        z = h.float()
        u = z.abs() * _INV_SQRT2
        a = torch.clamp(u, max=3.9)
        c1, c2, c3, c4, c5, c6 = _ERF_G
        gp = c1 + a * (2 * c2 + a * (3 * c3 + a * (4 * c4 + a * (5 * c5 + a * 6 * c6))))
        e = torch.exp2(-a * (c1 + a * (c2 + a * (c3 + a * (c4 + a * (c5 + a * c6))))))
        sel = torch.where(z >= 0, 2.0 - e, e)
        slope = torch.where(u < 3.9, gp * e * (_LN2 * _INV_SQRT2), 0.0)
        return (g.float() * (0.5 * sel + 0.5 * z * slope)).to(h.dtype)


def linear_gelu_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of H3. x [M, K], w [F, K], b [F] -> [M, F] in x.dtype.
    Operands are upcast to fp32 (exact for bf16), so the sum is fp32 and
    the bias is added before any rounding."""
    z = torch.matmul(x.float(), w.float().t()) + b.float()
    z = z.to(x.dtype).float()
    act = _gelu_fast if x.dtype == torch.bfloat16 else _gelu
    return act(z).to(x.dtype)


def linear_gelu_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch H3 on x's current stream: x [M, K] and w [F, K] both bf16 (H3)
    or both fp32 (H3-fp32), b [F]; the output has x's dtype."""
    global launches, f32_launches
    from jepa_tpu_torch.ops._build import check, load_library

    if not (x.is_cuda and w.device == x.device and b.device == x.device):
        raise ValueError("linear_gelu_cuda: x, w, b must be on one CUDA device")
    if x.dtype != w.dtype or x.dtype not in _KERNEL_K_STEP:
        raise NotImplementedError(
            f"linear_gelu_cuda takes bf16 or fp32 x and w of one dtype, got "
            f"{x.dtype}/{w.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise NotImplementedError("linear_gelu_cuda is forward-only; call it "
                                  "under torch.no_grad()")
    if x.dim() != 2 or w.dim() != 2 or b.shape != (w.shape[0],):
        raise ValueError(f"linear_gelu_cuda: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} b{tuple(b.shape)}")
    m, k = x.shape
    f, k2 = w.shape
    k_step = _KERNEL_K_STEP[x.dtype]
    if k != k2 or k % k_step or f % 128 or m < 1:
        raise ValueError(f"linear_gelu_cuda: needs K % {k_step} == 0 and F % 128 == 0, "
                         f"got M={m} K={k} F={f}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("linear_gelu_cuda: x and w must be contiguous")
    b = b.float().contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("linear_gelu_cuda: x, w and b must be 16-byte aligned")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    entry = "jt_linear_gelu_bf16" if x.dtype == torch.bfloat16 else "jt_linear_gelu_f32"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(getattr(load_library(), entry)(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                         out.data_ptr(), m, k, f, stream), entry)
    if x.dtype == torch.bfloat16:
        launches += 1
    else:
        f32_launches += 1
    return out


def fused_tiling(m: int, k: int, f: int) -> bool:
    """Do the kernels take x [M, K] @ w [F, K]^T? The JAX kernel's tiling
    rule (jepa_tpu/ops/fused_mlp.py:277); other shapes take the plain
    exact-erf path in both packages."""
    return not (k % 128 or f % 256 or m < 8)


def linear_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w.T + b) with the GELU fused into the matmul epilogue.

    x: [..., K] (compute dtype); w: [F, K]; b: [F]. Returns [..., F] in
    x's dtype. Shapes the kernel's tiling does not cover take the plain
    exact-erf path, as in jepa_tpu/ops/fused_mlp.py:277.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    f = w.shape[0]
    m = x.numel() // k if k else 0
    if not fused_tiling(m, k, f):
        h = torch.matmul(x.float(), w.float().t()) + b.float()
        return torch.nn.functional.gelu(h).to(x.dtype)
    x2 = x.reshape(m, k)
    if x2.is_cuda:
        out = linear_gelu_cuda(x2.contiguous(), w.contiguous(), b)
    else:
        out = linear_gelu_ref(x2, w, b)
    return out.reshape(*lead, f)


def resolve_fused_mlp(x: torch.Tensor) -> bool:
    """Fused-fc1 eligibility: CUDA tensors only (the JAX package's rule is
    TPU only). Independent of the attention dispatch."""
    return x.is_cuda
