"""Fused fc1 matmul + bias + GELU (counterpart of jepa_tpu/ops/fused_mlp.py).

``linear_gelu`` is the MLP's first layer on grad-free forwards. For a CUDA
tensor it launches the hand-written Hopper kernel H3
(``csrc/fused_mlp.cu``); for a CPU tensor it runs ``linear_gelu_ref``, the
plain PyTorch version of the same math. Weights keep the ``nn.Linear``
layout [F, K].

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
_ERF_G = (1.6279511504838011, 0.9179117972647749, 0.15048427545502158,
          -0.03191463214715457, 0.004236621237891429, -0.00025575246004894803)

launches = 0  # H3 launches in this process (wrapper-counted)


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


def linear_gelu_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of H3. x [M, K], w [F, K], b [F] -> [M, F] in x.dtype.
    Operands are upcast to fp32 (exact for bf16), so the sum is fp32 and
    the bias is added before any rounding."""
    z = torch.matmul(x.float(), w.float().t()) + b.float()
    z = z.to(x.dtype).float()
    act = _gelu_fast if x.dtype == torch.bfloat16 else _gelu
    return act(z).to(x.dtype)


def linear_gelu_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch H3 on x's current stream. x [M, K] bf16, w [F, K] bf16, b [F]."""
    global launches
    from jepa_tpu_torch.ops._build import check, load_library

    if not (x.is_cuda and w.device == x.device and b.device == x.device):
        raise ValueError("linear_gelu_cuda: x, w, b must be on one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"linear_gelu_cuda takes bf16 x and w, got {x.dtype}/{w.dtype} "
            "(the fp32 H3 variant is not written yet)")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise NotImplementedError("linear_gelu_cuda is forward-only; call it "
                                  "under torch.no_grad()")
    if x.dim() != 2 or w.dim() != 2 or b.shape != (w.shape[0],):
        raise ValueError(f"linear_gelu_cuda: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} b{tuple(b.shape)}")
    m, k = x.shape
    f, k2 = w.shape
    if k != k2 or k % 32 or f % 128 or m < 1:
        raise ValueError(f"linear_gelu_cuda: needs K % 32 == 0 and F % 128 == 0, "
                         f"got M={m} K={k} F={f}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("linear_gelu_cuda: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("linear_gelu_cuda: x and w must be 16-byte aligned")
    b = b.float().contiguous()
    out = torch.empty((m, f), dtype=torch.bfloat16, device=x.device)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(lib.jt_linear_gelu_bf16(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), m, k, f, stream),
          "jt_linear_gelu_bf16")
    launches += 1
    return out


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
    if k % 128 or f % 256 or m < 8:  # the JAX kernel's tiling rule
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
