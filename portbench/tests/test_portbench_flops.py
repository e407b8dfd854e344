"""The frozen FLOP and bound arithmetic against hand counts at the cells'
shapes."""

import pytest

from portbench import flops as F

H100_MMA, H100_EXP2, H100_BW = 989e12, 132 * 16 * 1.98e9, 3.35e12


def test_vit_flops_per_token_vitl16():
    # per block: qkv 3 d^2, proj d^2, fc1 + fc2 2 * 4 d^2 multiply-adds, and the
    # two N x N x d attention products, each a multiply-add a token
    d, n = 1024, 1568
    per_block = 2 * (3 * d * d + d * d + 8 * d * d) + 2 * (2 * n * d)
    assert per_block == 31588352
    assert F.vit_flops_per_token(d, 24, 4.0, n) == 24 * per_block


@pytest.mark.parametrize("dim,depth,n,batch,keep", [
    (1024, 24, 1568, 24, [(376, 733), (96, 1095)]),
    (1280, 32, 4608, 10, [(1261, 2303), (399, 3324)])])
def test_train_step_flops_equal_the_ports_and_a_hand_count(dim, depth, n, batch, keep):
    from jepa_tpu_torch.utils.logging import train_step_flops

    args = dict(enc_dim=dim, enc_depth=depth, enc_mlp=4.0, pred_dim=384, pred_depth=12,
                n_full=n, ctx_lens=[k[0] for k in keep], tgt_lens=[k[1] for k in keep],
                batch=batch, patch_dim=1536)
    ours = F.train_step_flops(**args)
    assert ours == train_step_flops(**args)
    blk = lambda d, s: 2 * 12 * d * d + 4 * s * d  # one block's forward FLOPs a token
    target = n * depth * blk(dim, n) + 2 * n * 1536 * dim
    ctx = sum(k * depth * blk(dim, k) + 2 * n * 1536 * dim for k, _ in keep)
    pred = sum((a + b) * 12 * blk(384, a + b) + 2 * (a + b) * dim * 384 for a, b in keep)
    assert ours == pytest.approx(batch * (target + 3 * (ctx + pred)), rel=1e-12)
    if dim == 1024:  # 61.6 TFLOP an update of ViT-L at B=24
        assert 61.6e12 < ours < 61.7e12


def test_attention_bounds_at_the_vitl16_target():
    b, n, h, c = 24, 1568, 16, 64
    mma = 2 * 2 * b * h * n * n * c / H100_MMA * 1e3
    exp2 = b * h * n * n / H100_EXP2 * 1e3
    byt = (3 * b * n * h * c * 2 + b * n * h * c * 2 + b * h * n * 4) / H100_BW * 1e3
    assert F.attn_fwd_bound_ms(b, n, h, c) == pytest.approx(max(mma, exp2, byt), rel=1e-12)
    assert mma > exp2 > byt  # this shape is MMA-bound
    bwd = max(5 * 2 * b * h * n * n * c / H100_MMA * 1e3, exp2,
              (3 * b * n * h * c * 2 * 2 + b * n * h * c * 2 + 2 * b * h * n * 4) / H100_BW * 1e3)
    assert F.attn_bwd_bound_ms(b, n, h, c) == pytest.approx(bwd, rel=1e-12)


def test_attention_bound_of_an_update_sums_its_calls():
    keep = [(376, 733), (96, 1095)]
    calls = F.update_attention_calls(n_full=1568, heads=16, head_dim=64, depth=24,
                                     pred_heads=16, pred_head_dim=24, pred_depth=12, keep=keep)
    assert calls == [(1568, 16, 64, 24, False), (376, 16, 64, 24, True),
                     (1109, 16, 24, 12, True), (96, 16, 64, 24, True), (1191, 16, 24, 12, True)]
    want = 24 * F.attn_fwd_bound_ms(24, 1568, 16, 64)
    for n, h, c, layers, _ in calls[1:]:
        want += layers * (F.attn_fwd_bound_ms(24, n, h, c) + F.attn_bwd_bound_ms(24, n, h, c))
    assert F.attention_bound_ms(calls, 24) == pytest.approx(want, rel=1e-12)


def test_fc1_bound_vitl16_b24():
    m, k, f = 24 * 1568, 1024, 4096
    ops = 2 * m * k * f / H100_MMA * 1e3
    byt = (2 * m * k + 2 * f * k + 4 * f + 2 * m * f) / H100_BW * 1e3
    assert F.fc1_bound_ms(m, k, f) == pytest.approx(max(ops, byt), rel=1e-12)
    assert ops > byt


def test_serve_flops_per_clip_vitl16():
    d, n = 1024, 1568
    enc = n * F.vit_flops_per_token(d, 24, 4.0, n) + 2 * n * 1536 * d
    probe = 2 * d * d + 2 * n * d * 2 * d + 4 * n * d + 2 * 2 * d * 4 * d + 2 * d * 400
    assert F.serve_flops_per_clip(dim=d, depth=24, mlp_ratio=4.0, n=n, patch_dim=1536,
                                  num_classes=400) == enc + probe
    assert 1.2e12 < enc + probe < 1.3e12
