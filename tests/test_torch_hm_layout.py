"""H4's TMA maps against the head-major operands the shipped routes hand
the kernels.

H4 reads q, k, v and writes o through 4-D TMA maps (C, N, H, B) built
from each operand's (batch, head, row) strides, which TMA takes only as
positive multiples of 16 bytes from a 16-byte aligned base
(``check_hm_tma_layout``, called by ``_check_hm`` before every H4-H7
launch). The CPU has no tensor maps, so this holds the integers: the
operands of vit_tiny's self-attention route (permuted views of the
token-major projection), of ``flash_attention_packed`` and of
``dot_product_attention(impl='flash')`` (the probe's cross-attention),
as the plain versions receive them, must pass as they are (no copy), and
layouts TMA cannot address must be refused. The fp32 instances
(H4-H7-fp32) read the same operands with 16-byte copies, so the same rule
holds at 4-byte elements.
"""

import pytest
import torch

from jepa_tpu_torch.ops import flash_attention as fa
from jepa_tpu_torch.ops.attention import dot_product_attention


def _spy_operands(monkeypatch):
    """Record every [B, H, N, c] tensor (q, k, v, do and the outputs the
    backward writes into) that reaches the head-major plain versions."""
    seen = []
    for kind in ("fwd", "bwd_dq", "bwd_dkv", "bwd_dqkv"):
        ref = getattr(fa, f"flash_{kind}_hm_ref")

        def spy(*args, _ref=ref, _kind=kind, **kw):
            names = ("q", "k", "v") if _kind == "fwd" else ("q", "k", "v", "do")
            ops = dict(zip(names, args))
            out = kw.get("out")
            for i, t in enumerate((out,) if isinstance(out, torch.Tensor) else out or ()):
                ops[f"out{i}"] = t
            if _kind == "fwd":
                ops["o"] = fa._alloc_like(args[0])  # the buffer the CUDA wrapper allocates
            seen.append((_kind, ops))
            return _ref(*args, **kw)

        monkeypatch.setattr(fa, f"flash_{kind}_hm_ref", spy)
    return seen


def _check_all(seen, want_kinds):
    assert {k for k, _ in seen} == want_kinds
    for kind, ops in seen:
        for name, t in ops.items():
            assert t.dim() == 4 and t.stride(-1) == 1, (kind, name)
            fa.check_hm_tma_layout(t.data_ptr(), t.stride()[:3], t.element_size())
            if name in ("q", "k", "v", "do"):
                assert fa._hm_operand(t) is t, (kind, name, t.stride())  # read in place


@pytest.mark.parametrize("n,kinds", [
    (376, {"fwd", "bwd_dqkv"}),             # vit_tiny's fixed context: the merged backward
    (1568, {"fwd", "bwd_dq", "bwd_dkv"}),   # vit_tiny's full clip: the split backward
])
def test_vit_tiny_self_attention_operands(monkeypatch, n, kinds):
    """vit_tiny (3 heads of 64) has no token-major head split, so its
    self-attention runs head-major on permuted views of the projection."""
    heads, c, d = 3, 64, 192
    assert fa.self_attention_route(heads, c, n) == "hm"
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, n, d), generator=gen).to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn((3 * d, d), generator=gen) / 16).to(torch.bfloat16)
    b = torch.zeros(3 * d)
    seen = _spy_operands(monkeypatch)
    o = fa.flash_self_attention(x, w, b, heads)
    o.float().sum().backward()
    _check_all(seen, kinds)


def test_packed_qkv_operands(monkeypatch):
    """flash_attention_packed reads the three planes of [3, B, H, N, c] and
    writes dq, dk, dv into the planes of one dqkv laid out like it."""
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn((3, 2, 3, 149, 32), generator=gen).to(torch.bfloat16).requires_grad_(True)
    seen = _spy_operands(monkeypatch)
    fa.flash_attention_packed(qkv).float().sum().backward()
    _check_all(seen, {"fwd", "bwd_dqkv"})


def test_packed_qkv_split_operands(monkeypatch):
    """flash_attention_packed at vit_tiny's full clip takes the split
    backward: H5 writes dq into the q plane of the packed dqkv, H6 dk and
    dv into the others, each as it is."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((3, 1, 1, 1568, 64), generator=gen).to(torch.bfloat16).requires_grad_(True)
    seen = _spy_operands(monkeypatch)
    fa.flash_attention_packed(qkv).float().sum().backward()
    _check_all(seen, {"fwd", "bwd_dq", "bwd_dkv"})
    dq_out = next(ops["out0"] for kind, ops in seen if kind == "bwd_dq")
    assert dq_out.data_ptr() == qkv.grad.data_ptr()  # the q plane, written in place


def test_probe_cross_attention_operands(monkeypatch):
    """dot_product_attention(impl='flash') as the attentive probe calls it:
    one query token over the feature sequence, k and v the planes of one
    [B, N, 2, H, c] projection, all token-major views."""
    gen = torch.Generator().manual_seed(2)
    bsz, n, heads, c = 2, 196, 16, 64
    q = torch.randn((bsz, 1, heads, c), generator=gen).to(torch.bfloat16).requires_grad_(True)
    kv = torch.randn((bsz, n, 2, heads, c), generator=gen).to(torch.bfloat16).requires_grad_(True)
    k, v = kv.unbind(2)
    seen = _spy_operands(monkeypatch)
    dot_product_attention(q, k, v, impl="flash").float().sum().backward()
    want = {"fwd", "bwd_dqkv"} if fa.merged_bwd(1, n, c) else {"fwd", "bwd_dq", "bwd_dkv"}
    _check_all(seen, want)


@pytest.mark.parametrize("n,heads,c,kinds", [
    (376, 3, 64, {"fwd", "bwd_dqkv"}),             # vit_tiny's fixed context
    (1568, 3, 64, {"fwd", "bwd_dq", "bwd_dkv"}),   # vit_tiny's full clip
    (1109, 3, 32, {"fwd", "bwd_dqkv"}),            # the 96-wide predictor's
    (1664, 3, 32, {"fwd", "bwd_dq", "bwd_dkv"}),   # its padded top rung
])
def test_f32_self_attention_operands(monkeypatch, n, heads, c, kinds):
    """fp32 (H4-H7-fp32): the same routes hand the packed planes of the
    token-major projection at 4-byte elements, which pass the 16-byte rule
    with elem_bytes=4 (the kernels' float4 copies) and are read in place."""
    d = heads * c
    assert fa.self_attention_route(heads, c, n) == "hm"
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((1, n, d), generator=gen).requires_grad_(True)
    w = torch.randn((3 * d, d), generator=gen) / 16
    seen = _spy_operands(monkeypatch)
    o = fa.flash_self_attention(x, w, torch.zeros(3 * d), heads)
    o.backward(torch.randn(o.shape, generator=gen))  # a dense gradient, as attn.proj's
    assert all(t.dtype == torch.float32 for _, ops in seen for t in ops.values())
    _check_all(seen, kinds)
    for _, ops in seen:
        for t in ops.values():
            fa.check_hm_tma_layout(t.data_ptr(), t.stride()[:3], elem_bytes=4)


_TOK = 1568 * 3 * 3 * 64  # a vit_tiny projection's batch stride, in elements


@pytest.mark.parametrize("ptr,strides,ok", [
    (0, (_TOK, 64, 3 * 3 * 64), True),           # a permuted view of the projection
    (4096, (3 * 1568 * 64, 1568 * 64, 64), True),  # a contiguous [B, H, N, c]
    (16, (1568 * 64, 64, 3 * 64), True),         # a plane at a 16-byte offset
    (8, (_TOK, 64, 3 * 3 * 64), False),          # an 8-byte aligned base
    (0, (_TOK, 64, 36), False),                  # a 72-byte row stride
    (0, (_TOK, 4, 576), False),                  # an 8-byte head stride
    (0, (0, 64, 576), False),                    # an expanded batch (stride 0)
    (0, (_TOK, 64, -576), False),                # a flipped sequence
    (0, (2**31, 64, 576), False),                # past a 32-bit stride
])
def test_hm_tma_layout_check(ptr, strides, ok):
    """The pure-integer check itself: every base and stride a positive
    multiple of 16 bytes below 2^31 elements."""
    if ok:
        fa.check_hm_tma_layout(ptr, strides)
    else:
        with pytest.raises(ValueError):
            fa.check_hm_tma_layout(ptr, strides)
