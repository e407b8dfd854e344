"""The shipped-config dispatch table: for each of the 3 pretrain and 15 eval
YAMLs in configs/ (the evals in both use_bfloat16 settings), for
vitl16.yaml and vitl16_k400_16x8x3.yaml with the factory's largest models
(vit_giant, vit_gigantic and vit_gigantic_intended, the gigantics at their
patch 14), for vitl16_k400_16x8x3.yaml with vit_tiny in both dtypes, and
for vitl16.yaml with model_name vit_tiny (bf16, and fp32 in both mask
modes with the 384- and the 96-wide predictor), every attention and fc1 call shape
the port's path makes, resolved through the port's own dispatch rules
(resolve_flash, self_attention_route, padded_head_dim, merged_bwd, the
kernels' head dims, fused_tiling, the kernels' k panels) on a stand-in for
a CUDA tensor. Each call must reach a kernel instance that exists (a C
entry the build binds and a source defines: H1 by head dim and dtype, H2
for a differentiated H1, H4 and H7 or H5 + H6 on the head-major route (the
fp32 instances H4-H7-fp32 in fp32), H3
by K/F tiling and dtype, H8 for a fused fc1 under a gradient) or the
documented eager path: attention with fewer than 128 queries or keys (the
probe's 1-query cross-attention, short contexts), head-major sequences past
2048 tokens, the unfused differentiated fc1 (probe, predictor, the context
encoder unless ``fused_mlp='force'``) and an fc1 outside the kernels'
tiling. No model runs. ``pytest -s``
prints the table.

The call lists (``_eval_calls``, ``_pretrain_calls``) restate the call
graph of models/{vit,transformer,attentive,predictor}.py and of the evals'
and the train step's batching: a change there that adds, drops or
reshapes an attention or fc1 call must be made here too.
"""

import dataclasses
import pathlib
import re
import types

import pytest
import torch
import yaml

from jepa_tpu_torch.masks.multiblock3d import MaskGrid, MaskSpec, calibrate_keep_counts
from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
from jepa_tpu_torch.ops import _build
from jepa_tpu_torch.ops.attention import resolve_flash
from jepa_tpu_torch.ops.flash_attention import (
    F32_BWD_HEAD_DIMS,
    F32_HEAD_DIMS,
    HM_F32_HEAD_DIMS,
    HM_HEAD_DIMS,
    KERNEL_HEAD_DIMS,
    check_tma_layout,
    merged_bwd,
    padded_head_dim,
    self_attention_route,
)
from jepa_tpu_torch.ops.fused_mlp import check_kernel_tiling, fused_tiling, resolve_fused_mlp

_CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
_CARD = types.SimpleNamespace(is_cuda=True)  # what the dispatch reads of a CUDA tensor
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _source_entries():
    """The C entry points the sources define, macros expanded."""
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    names = set(re.findall(r'extern "C" int (jt_\w+)\(', src))
    for macro, body in re.findall(r"#define (\w+)\(C\)(.*?)\n\n", src, re.S):
        stems = re.findall(r"(jt_\w+?)_c##C", body)
        for c in re.findall(rf"^{macro}\((\d+)\)", src, re.M):
            names |= {f"{s}_c{c}" for s in stems}
    return names


_ENTRIES = _source_entries()


@dataclasses.dataclass
class Attn:
    where: str
    nq: int
    nk: int
    heads: int
    c: int
    dtype: torch.dtype
    grad: bool = False
    cross: bool = False


@dataclasses.dataclass
class Fc1:
    where: str
    m: int
    k: int
    f: int
    dtype: torch.dtype
    fused: bool
    grad: bool = False


def _eval_calls(cfg, bf16):
    p, d, o = cfg["pretrain"], cfg["data"], cfg["optimization"]
    dt = torch.bfloat16 if bf16 else torch.float32
    res = o.get("resolution", d.get("resolution", 224))
    enc = vit_cfg(p["model_name"], img_size=res, patch_size=p["patch_size"],
                  num_frames=p["frames_per_clip"], tubelet_size=p["tubelet_size"],
                  uniform_power=p["uniform_power"], compute_dtype=dt, fused_mlp=True)
    n, b = enc.num_patches, o["batch_size"]
    if cfg["eval_name"] == "video_classification_frozen":
        s, v = d.get("num_segments", 1), d.get("num_views_per_segment", 1)
        attend = o.get("attend_across_segments", False)
        clips = {"train": b * (s if attend else 1), "val": b * s * v}
        probe_nk = s * n if attend else n
    else:  # each image repeated over the video encoder's frames
        clips, probe_nk = {"train": b, "val": b}, n
    c = enc.embed_dim // enc.num_heads
    calls = []
    for step, nc in clips.items():
        calls += [Attn(f"{step} encoder self-attn x{nc}", n, n, enc.num_heads, c, dt),
                  Fc1(f"{step} encoder fc1", nc * n, enc.embed_dim, enc.mlp_hidden, dt, True),
                  Attn(f"{step} probe cross-attn", 1, probe_nk, enc.num_heads, c, dt, True, True),
                  Fc1(f"{step} probe fc1", b, enc.embed_dim, enc.mlp_hidden, dt, False)]
    return calls


def _pretrain_calls(cfg, model_name=None, force=False, keep=None):
    """``force``: the encoder built with ``fused_mlp='force'`` (the context
    fc1 fused and differentiated); ``keep``: the (context, target) token
    counts of each mask config, else the multiblock calibration's."""
    m, d = cfg["model"], cfg["data"]
    m["model_name"] = model_name or m["model_name"]
    dt = _DTYPES[str(cfg["meta"].get("dtype", "bfloat16"))]
    enc = vit_cfg(m["model_name"], img_size=d["crop_size"], patch_size=d["patch_size"],
                  num_frames=d["num_frames"], tubelet_size=d["tubelet_size"],
                  uniform_power=m["uniform_power"], compute_dtype=dt)
    pred = predictor_cfg_for(enc, predictor_embed_dim=m["pred_embed_dim"], depth=m["pred_depth"],
                             num_mask_tokens=len(cfg["mask"]))
    grid = MaskGrid.from_data_cfg(d["crop_size"], d["patch_size"], d["num_frames"],
                                  d["tubelet_size"])
    if keep is None:
        keep = [calibrate_keep_counts(MaskSpec.from_cfg(x), grid, d["batch_size"])
                for x in cfg["mask"]]
    n, b = enc.num_patches, d["batch_size"] * d.get("num_clips", 1)
    c, pc = enc.embed_dim // enc.num_heads, pred.predictor_embed_dim // pred.num_heads
    calls = [Attn("target self-attn", n, n, enc.num_heads, c, dt),
             Fc1("target fc1", b * n, enc.embed_dim, enc.mlp_hidden, dt, True)]
    for i, (ke, kp) in enumerate(keep):
        calls += [Attn(f"mask {i} context self-attn", ke, ke, enc.num_heads, c, dt, True),
                  Fc1(f"mask {i} context fc1", b * ke, enc.embed_dim, enc.mlp_hidden, dt,
                      force, True),
                  Attn(f"mask {i} predictor self-attn", ke + kp, ke + kp, pred.num_heads, pc,
                       dt, True),
                  Fc1(f"mask {i} predictor fc1", b * (ke + kp), pred.predictor_embed_dim,
                      int(pred.predictor_embed_dim * pred.mlp_ratio), dt, False, True)]
    return calls


def _resolve(call):
    """The kernel entries (or the eager path) a call resolves to; asserts
    the entries exist."""
    entries = _entries(call)
    if isinstance(entries, str):
        return entries
    for e in entries:
        assert e in _build._SIGNATURES and e in _ENTRIES, (call, e)
    return " + ".join(entries)


def _entries(call):
    """The kernel entries a call needs, whether or not they exist yet, or
    the eager path it runs."""
    if isinstance(call, Attn):
        if call.cross or not resolve_flash("auto", call.nq, call.nk, _CARD):
            # separate q/k/v and short sequences run xla_attention, as the JAX
            # package runs them in XLA ('auto' needs nq, nk >= 128)
            assert min(call.nq, call.nk) < 128, call
            return "eager xla_attention"
        route = self_attention_route(call.heads, call.c, call.nq)
        if route == "eager":  # no token-major split and past 2048 tokens
            return "eager xla_attention"
        if route == "hm":  # flash_attention_packed: H4, then H7 or H5 + H6
            f32 = "_f32" if call.dtype == torch.float32 else ""  # H4-H7-fp32
            assert call.c in (HM_F32_HEAD_DIMS if f32 else HM_HEAD_DIMS), call
            entries = [f"jt_flash_hm_fwd{f32}_c{call.c}"]
            if call.grad:
                kinds = ["dqkv"] if merged_bwd(call.nq, call.nk, call.c) else ["dq", "dkv"]
                entries += [f"jt_flash_hm_{k}{f32}_c{call.c}" for k in kinds]
        else:
            entries = _tm_entries(call)
    else:
        if not call.fused:
            return "eager linear + GELU (differentiated)"
        if not fused_tiling(call.m, call.k, call.f):  # vit_tiny's K=192, in both packages
            return "eager linear + exact GELU (outside the kernels' tiling)"
        assert resolve_fused_mlp(_CARD), call
        check_kernel_tiling(call.m, call.k, call.f, call.dtype)  # the wrapper's own check
        kind = "_z" if call.grad else ""  # H8 (LinearGelu's forward) or H3
        entries = [f"jt_linear_gelu{kind}_bf16" if call.dtype == torch.bfloat16
                   else f"jt_linear_gelu{kind}_f32"]
    return entries


def _tm_entries(call):
    """H1 (and H2 under a gradient) at the padded head dim and the dtype:
    bf16 H1 / H2, or H1-fp32 / H2-fp32."""
    cp = padded_head_dim(call.c)
    f32 = "_f32" if call.dtype == torch.float32 else ""
    if not f32:
        assert cp in KERNEL_HEAD_DIMS, call
        check_tma_layout(call.heads, cp)  # H1's TMA maps, as the wrapper checks them
    entries = [f"jt_flash_fwd{f32}_c{cp}"]
    if call.grad:  # FlashSelfAttentionFn: H2 or H2-fp32 for the backward
        entries += [f"jt_flash_bwd_dkv{f32}_c{cp}", f"jt_flash_bwd_dq{f32}_c{cp}"]
    return entries


def test_f32_head_dims_are_the_entries():
    """The wrapper's fp32 head dims (H1-fp32, H2-fp32, H4-H7-fp32) are
    exactly the instances the sources define and the build binds."""
    f32 = lambda stem: {int(e.rsplit("_c", 1)[1]) for e in _ENTRIES if e.startswith(stem)}
    assert f32("jt_flash_fwd_f32_c") == set(F32_HEAD_DIMS)
    assert f32("jt_flash_bwd_dkv_f32_c") == f32("jt_flash_bwd_dq_f32_c") == set(F32_BWD_HEAD_DIMS)
    for kind in ("fwd", "dq", "dkv", "dqkv"):
        assert f32(f"jt_flash_hm_{kind}_f32_c") == set(HM_F32_HEAD_DIMS), kind
    for e in _ENTRIES:
        if "_f32_c" in e:
            assert e in _build._SIGNATURES, e


# (model_name, patch_size) run on vitl16.yaml's and vitl16_k400_16x8x3.yaml's
# geometry (no shipped YAML names them), and the head dim each encoder's
# attention runs at (88 and 104 zero-padded)
_MODELS = {"vit_giant": 16, "vit_gigantic": 14, "vit_gigantic_intended": 14}
_PADDED = {"vit_giant": 96, "vit_gigantic": 128, "vit_gigantic_intended": 128}
_CASES = ([(p.name, None, None) for p in sorted((_CONFIGS / "pretrain").glob("*.yaml"))]
          + [(p.name, bf16, None) for p in sorted((_CONFIGS / "evals").glob("*.yaml"))
             for bf16 in (True, False)]
          + [("vitl16.yaml", None, m) for m in _MODELS]
          + [("vitl16_k400_16x8x3.yaml", bf16, m) for m in (*_MODELS, "vit_tiny")
             for bf16 in (True, False)])


def test_shipped_configs_are_all_listed():
    shipped = [c for c in _CASES if c[2] is None]
    assert len([c for c in shipped if c[1] is None]) == 3
    assert len([c for c in shipped if c[1] is not None]) == 2 * 15


@pytest.mark.parametrize("name,bf16,model", _CASES,
                         ids=[f"{n}-{'pretrain' if b is None else ('bf16' if b else 'fp32')}"
                              + (f"-{m}" if m else "") for n, b, m in _CASES])
def test_shipped_config_dispatch(name, bf16, model):
    kind = "pretrain" if bf16 is None else "evals"
    cfg = yaml.safe_load((_CONFIGS / kind / name).read_text())
    if model:  # the model and its factory patch in place of the YAML's
        sec = cfg["model"] if bf16 is None else cfg["pretrain"]
        sec["model_name"] = model
        (cfg["data"] if bf16 is None else sec)["patch_size"] = _MODELS.get(model, 16)
    calls = _pretrain_calls(cfg) if bf16 is None else _eval_calls(cfg, bf16)
    table = [(call, _resolve(call)) for call in calls]
    print(f"\n{kind}/{name}" + ("" if bf16 is None else f" use_bfloat16={bf16}"))
    for call, how in table:
        shape = (f"nq={call.nq} nk={call.nk} H={call.heads} c={call.c}"
                 if isinstance(call, Attn) else f"M={call.m} K={call.k} F={call.f}")
        print(f"  {call.where:32s} {shape:34s} {str(call.dtype)[6:]:8s} -> {how}")
    # every shipped path runs the encoder's attention and fc1 through kernels
    # (vit_tiny's fc1, K=192, runs the eager GELU in both packages)
    assert all(how.startswith("jt_") for call, how in table
               if ("encoder" in call.where or "target" in call.where)
               and not (model == "vit_tiny" and isinstance(call, Fc1)))
    f32 = "_f32" if bf16 is False else ""
    if model == "vit_tiny":  # 3 heads of 64: H4 (H4-fp32 in the fp32 eval)
        assert [how for call, how in table if "encoder self-attn" in call.where] == [
            f"jt_flash_hm_fwd{f32}_c64"] * 2
    elif model:  # H1 (H1-fp32 in an fp32 eval) at the padded head dim
        assert all(how.startswith(f"jt_flash_fwd{f32}_c{_PADDED[model]}") for call, how in table
                   if isinstance(call, Attn) and not call.cross
                   and ("encoder" in call.where or "target" in call.where
                        or "context" in call.where) and not how.startswith("eager"))


def test_vit_tiny_pretrain_dispatch():
    """vitl16.yaml with model_name vit_tiny: the encoder (3 x 64, no
    token-major split) runs the head-major kernels (the target H4, the long
    context H4 + H7, the short context eager), the 384-wide predictor
    (3 x 128) H1 + H2 at head dim 128, and the fc1 (K=192) the eager GELU."""
    cfg = yaml.safe_load((_CONFIGS / "pretrain" / "vitl16.yaml").read_text())
    table = [(call, _resolve(call)) for call in _pretrain_calls(cfg, "vit_tiny")]
    for call, how in table:
        print(f"  {call.where:32s} -> {how}")
    got = {call.where: how for call, how in table}
    assert got["target self-attn"] == "jt_flash_hm_fwd_c64"
    assert got["target fc1"].startswith("eager")
    assert got["mask 0 context self-attn"] == "jt_flash_hm_fwd_c64 + jt_flash_hm_dqkv_c64"
    assert got["mask 1 context self-attn"] == "eager xla_attention"  # 96 keys
    for i in (0, 1):
        assert got[f"mask {i} predictor self-attn"] == (
            "jt_flash_fwd_c128 + jt_flash_bwd_dkv_c128 + jt_flash_bwd_dq_c128")


@pytest.mark.parametrize("mode", ["fixed", "padded"])
def test_tube_pretrain_dispatch(mode):
    """vitl16.yaml with ``data.mask_type: random_tube`` and one mask of
    ratio 0.9: the fixed (tube) mode keeps 152 tokens exactly and predicts
    1416; the padded mode pads them to one tier of static caps, 256 and
    1536 (152 and 1416 valid), so the key mask reaches the masked H1/H2.
    Both resolve the context (c=64) and the predictor (c=24 padded to 32)
    to H1 + H2."""
    from jepa_tpu_torch.masks.padding import static_cap
    from jepa_tpu_torch.masks.random_tube import TubeSpec, keep_counts

    cfg = yaml.safe_load((_CONFIGS / "pretrain" / "vitl16.yaml").read_text())
    cfg["mask"] = [{"ratio": 0.9}]
    d = cfg["data"]
    grid = MaskGrid.from_data_cfg(d["crop_size"], d["patch_size"], d["num_frames"],
                                  d["tubelet_size"])
    ke, kp = keep_counts(TubeSpec.from_cfg(cfg["mask"][0]), grid)
    assert (ke, kp) == (152, 1416)
    if mode == "padded":
        ke, kp = static_cap(grid.n, ke / grid.n), static_cap(grid.n, kp / grid.n)
        assert (ke, kp) == (256, 1536)
    table = [(call, _resolve(call)) for call in _pretrain_calls(cfg, keep=[(ke, kp)])]
    for call, how in table:
        print(f"  {call.where:32s} -> {how}")
    got = {call.where: (call, how) for call, how in table}
    ctx, how = got["mask 0 context self-attn"]
    assert (ctx.nq, ctx.c) == (ke, 64)
    assert how == "jt_flash_fwd_c64 + jt_flash_bwd_dkv_c64 + jt_flash_bwd_dq_c64"
    pred, how = got["mask 0 predictor self-attn"]
    assert (pred.nq, pred.c) == (ke + kp, 24)
    assert how == "jt_flash_fwd_c32 + jt_flash_bwd_dkv_c32 + jt_flash_bwd_dq_c32"
    assert got["target fc1"][1] == "jt_linear_gelu_bf16"


@pytest.mark.parametrize("model_name", ["vit_large", "vit_tiny"])
def test_force_fused_mlp_pretrain_dispatch(model_name):
    """vitl16.yaml with the encoder's ``fused_mlp='force'``: ViT-L's context
    fc1 (K=1024, F=4096, M = 24 x each context) is differentiated and
    resolves to H8, the target's to H3, the predictor's stays eager;
    vit_tiny's fc1 (K=192) is outside the kernels' tiling, so it stays on
    the plain path under a gradient as without, in both packages."""
    cfg = yaml.safe_load((_CONFIGS / "pretrain" / "vitl16.yaml").read_text())
    got = {call.where: _resolve(call) for call in _pretrain_calls(cfg, model_name, force=True)}
    for where, how in got.items():
        print(f"  {where:32s} -> {how}")
    tiled = model_name == "vit_large"
    for i in (0, 1):
        assert got[f"mask {i} context fc1"] == (
            "jt_linear_gelu_z_bf16" if tiled
            else "eager linear + exact GELU (outside the kernels' tiling)")
        assert got[f"mask {i} predictor fc1"] == "eager linear + GELU (differentiated)"
    assert got["target fc1"] == ("jt_linear_gelu_bf16" if tiled
                                 else "eager linear + exact GELU (outside the kernels' tiling)")


@pytest.mark.parametrize("m,k,f,dtype,ok", [
    (8, 1024, 4096, torch.bfloat16, True),       # fused_tiling's smallest M
    (2305, 1280, 5120, torch.bfloat16, True),    # ViT-H's fc1, ragged M
    (3136, 1088, 4096, torch.bfloat16, True),    # K a multiple of 64, not of 128
    (3136, 1056, 4096, torch.bfloat16, False),   # K % 64 == 32: half a TMA box
    (3136, 1024, 4224, torch.bfloat16, True),    # F % 256 == 128: the kernels' tile is 128
    (3136, 1024, 4160, torch.bfloat16, False),   # F % 128 == 64: half a tile
    (3136, 1024, 4160, torch.float32, False),
    (3136, 1040, 4096, torch.float32, True),     # fp32: K % 16
    (3136, 1032, 4096, torch.float32, False),
    (0, 1024, 4096, torch.bfloat16, False),
])
def test_kernel_tiling_check(m, k, f, dtype, ok):
    """The fc1 wrapper's pure-integer check of the kernels' K/F tiles."""
    if ok:
        check_kernel_tiling(m, k, f, dtype)
    else:
        with pytest.raises(ValueError):
            check_kernel_tiling(m, k, f, dtype)


@pytest.mark.parametrize("k", [128, 256, 1024, 1280, 1408])
@pytest.mark.parametrize("f", [256, 4096, 5120, 6144])
def test_fused_tiling_admits_only_kernel_shapes(k, f):
    """Every shape the eligibility rule admits passes both kernels' checks."""
    for m in (8, 9, 127, 129, 3136):
        assert fused_tiling(m, k, f)
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel_tiling(m, k, f, dtype)


@pytest.mark.parametrize("heads,c,elem,ok", [
    (16, 64, 2, True), (16, 80, 2, True), (16, 32, 2, True), (3, 128, 2, True),
    (1, 32, 2, True), (16, 64, 4, True),
    (16, 36, 2, False),   # a head offset of 72 bytes
    (3, 20, 2, False),    # a head offset of 40 bytes
    (4, 4, 2, False),     # 8-byte head offset
    (2, 12, 4, True),     # fp32: 48-byte head offset, 96- and 288-byte rows
])
def test_tma_layout_check(heads, c, elem, ok):
    """H1's pure-integer check of the strides and head offsets TMA needs."""
    if ok:
        check_tma_layout(heads, c, elem)
    else:
        with pytest.raises(ValueError):
            check_tma_layout(heads, c, elem)


@pytest.mark.parametrize("name", ["vitl16.yaml", "vith16.yaml", "vith16_384.yaml",
                                  "vitl16.yaml:vit_giant", "vitl16.yaml:vit_gigantic"])
def test_jax_tm_kernel_picks(name):
    """Which TPU kernel the JAX package's pickers (``_pick_tm_fwd``,
    ``_pick_tm_bwd``) take at each token-major attention call of a shipped
    pretrain YAML (or vitl16.yaml with vit_giant, or vit_gigantic at its
    patch 14), the calls H1 and H2 run in the port; PERF.md's kernel
    table attributes the port's launches by it. The grad-free target takes
    the one-shot forward K1, but at vith16_384's N=4608, c=80 the kv-tiled
    K2 (vit_gigantic's N=2048 at c=128 takes K1); every trainable call
    takes K1 and the merged backward K3, so the dual-tiled K4 + K5 run on
    no shipped training call."""
    from jepa_tpu.ops.flash_attention import _pick_tm_bwd, _pick_tm_fwd

    name, _, model = name.partition(":")
    cfg = yaml.safe_load((_CONFIGS / "pretrain" / name).read_text())
    if model:
        cfg["model"]["model_name"] = model
        cfg["data"]["patch_size"] = _MODELS[model]
    picks = {}
    for call in _pretrain_calls(cfg):
        if not isinstance(call, Attn) or not _resolve(call).startswith("jt_flash_fwd"):
            continue
        cp = padded_head_dim(call.c)
        fwd = _pick_tm_fwd(call.heads, cp, call.nq)[1 if call.grad else 0][0]
        kinds = {"one": "K1", "tiled": "K2"}[fwd]
        if call.grad:
            kinds += " + " + {"merged": "K3", "tiled": "K4 + K5"}[_pick_tm_bwd(call.heads, cp,
                                                                          call.nq)[0]]
        picks[call.where] = kinds
        print(f"  {name} {call.where:28s} N={call.nq:5d} c={call.c}->{cp} -> {kinds}")
    assert picks["target self-attn"] == ("K2" if name == "vith16_384.yaml" else "K1")
    trainable = [v for k, v in picks.items() if k != "target self-attn"]
    # at 224 px mask 1's context (96 tokens) runs eager
    assert len(trainable) == (4 if name == "vith16_384.yaml" else 3)
    assert all(v == "K1 + K3" for v in trainable)


def _f32_vitl16(mode, model_name=None, config="vitl16.yaml", cfg=None, dtype="float32"):
    """``config`` (or the parsed ``cfg``) with ``meta.dtype: float32`` (or
    ``dtype``; and ``model_name``) in the fixed mode (the calibrated keep
    counts) or the padded mode (every rung of each mask config's cap
    ladder), as its call list."""
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders

    if cfg is None:
        cfg = yaml.safe_load((_CONFIGS / "pretrain" / config).read_text())
    cfg["meta"]["dtype"] = dtype
    keep = None
    if mode == "padded":
        d = cfg["data"]
        grid = MaskGrid.from_data_cfg(d["crop_size"], d["patch_size"], d["num_frames"],
                                      d["tubelet_size"])
        specs = [MaskSpec.from_cfg(x) for x in cfg["mask"]]
        keep = [r for rungs in calibrate_pad_ladders(specs, grid, d["batch_size"]) for r in rungs]
    return _pretrain_calls(cfg, model_name, keep=keep)


@pytest.mark.parametrize("mode", ["fixed", "padded"])
def test_f32_pretrain_dispatch(mode):
    """vitl16.yaml with ``meta.dtype: float32`` (ViT-L/16, fixed masks or
    every padded cap): every encoder and predictor self-attention at 128
    tokens or more resolves to H1-fp32 at c=64 (encoder) or c=24->32
    (predictor), and under a gradient to H2-fp32 at the same head dim; the
    target's fc1 to H3-fp32; nothing to a bf16 entry."""
    table = [(call, _resolve(call)) for call in _f32_vitl16(mode)]
    for call, how in table:
        print(f"  {mode} {call.where:32s} -> {how}")
    attn = [(call, how) for call, how in table if isinstance(call, Attn)]
    assert len(attn) == 1 + 2 * (2 if mode == "fixed" else 6)
    for call, how in attn:
        if how.startswith("eager"):  # fixed mode's 96-token context, as in the JAX package
            assert call.nq < 128 and mode == "fixed" and "context" in call.where, call
            continue
        cp = 64 if call.c == 64 else 32
        want = [f"jt_flash_fwd_f32_c{cp}"]
        if call.grad:
            want += [f"jt_flash_bwd_dkv_f32_c{cp}", f"jt_flash_bwd_dq_f32_c{cp}"]
        assert how == " + ".join(want), (call, how)
    assert sum("jt_flash_bwd_dq_f32" in how for _, how in attn) == (3 if mode == "fixed" else 12)
    fc1 = {call.where: how for call, how in table if isinstance(call, Fc1)}
    assert fc1["target fc1"] == "jt_linear_gelu_f32"
    assert not any("bf16" in how for _, how in table)


# (config, model, predictor width, mode) of a pretrain config with
# meta.dtype float32 whose every instance is ported: vitl16.yaml with
# vit_tiny with its 384-wide predictor (3 x 128, token-major: H1-fp32 +
# H2-fp32 at c=128) and the fixture's 96-wide one (3 x 32, head-major), and
# with vit_gigantic (16 x 104 padded to 128, patch 14) and vit_giant (16 x 88
# padded to 96); vith16.yaml and vith16_384.yaml (ViT-H, 16 x 80)
_F32_RESOLVED = [("vitl16.yaml", "vit_tiny", w, mode) for w in (384, 96)
                 for mode in ("fixed", "padded")] + [
    ("vitl16.yaml", "vit_gigantic", None, mode) for mode in ("fixed", "padded")] + [
    (config, model, None, mode) for config, model in (("vith16.yaml", None),
                                                      ("vith16_384.yaml", None),
                                                      ("vitl16.yaml", "vit_giant"))
    for mode in ("fixed", "padded")]
_F32_IDS = [f"{m}-{w or 'yaml'}-{mode}" if m in ("vit_tiny", "vit_gigantic")
            else f"{m or config[:-5]}-yaml-{mode}" for config, m, w, mode in _F32_RESOLVED]
# the encoder's padded head dim of each model on the token-major route
_F32_ENCODER_C = {"vit_gigantic": 128, "vit_giant": 96, "vit_huge": 80}


@pytest.mark.parametrize("config,model,pred_width,mode", _F32_RESOLVED, ids=_F32_IDS)
def test_f32_pretrain_resolves(config, model, pred_width, mode):
    """A pretrain config with ``meta.dtype: float32``: every call of the
    update reaches an fp32 entry or the eager path the JAX package takes.
    vit_tiny at vitl16.yaml: the encoder's self-attention (3 x 64, no
    token-major split) H4-fp32 and, under a gradient, H7-fp32 (the
    contexts: ``merged_bwd``); the 384-wide predictor H1-fp32 + H2-fp32 at
    c=128, the 96-wide predictor H4-fp32 and H7-fp32 at c=32 (H5-fp32 +
    H6-fp32 at the padded top rung, 1664 tokens, past the merged backward's
    rule); the fc1 (K=192) the eager GELU. vit_gigantic's, vit_giant's and
    ViT-H's (vith16.yaml, vith16_384.yaml) resolve to H1-fp32 / H2-fp32 at
    c=128, 96 and 80 (encoder) and c=32 (predictor) and H3-fp32. Nothing
    reaches a bf16 entry."""
    cfg = yaml.safe_load((_CONFIGS / "pretrain" / config).read_text())
    if pred_width:
        cfg["model"].update(pred_embed_dim=pred_width,
                            pred_depth=2 if pred_width == 96 else cfg["model"]["pred_depth"])
    if model in _MODELS:
        cfg["data"]["patch_size"] = _MODELS[model]
    model = model or cfg["model"]["model_name"]
    table = [(call, _resolve(call)) for call in _f32_vitl16(mode, model, cfg=cfg)]
    for call, how in table:
        print(f"  {config} {model} {pred_width} {mode} {call.where:32s} -> {how}")
    assert not any("bf16" in how or ("jt_" in how and "_f32" not in how) for _, how in table)
    for call, how in table:
        if how.startswith("eager"):  # fewer than 128 tokens, or the fc1 at K=192
            assert (isinstance(call, Attn) and call.nq < 128) or (
                isinstance(call, Fc1) and (model == "vit_tiny" or not call.fused)), (call, how)
            continue
        if not isinstance(call, Attn):
            assert how == "jt_linear_gelu_f32" and model in _F32_ENCODER_C, (call, how)
            continue
        pred = "predictor" in call.where
        if model in _F32_ENCODER_C:
            cp = 32 if pred else _F32_ENCODER_C[model]
            want = [f"jt_flash_fwd_f32_c{cp}"] + [
                f"jt_flash_bwd_{k}_f32_c{cp}" for k in ("dkv", "dq")] * call.grad
        elif pred and pred_width == 384:
            want = ["jt_flash_fwd_f32_c128"] + [
                f"jt_flash_bwd_{k}_f32_c128" for k in ("dkv", "dq")] * call.grad
        else:
            c = 32 if pred else 64  # the merged backward, or dq + dk/dv past it
            kinds = ["dqkv"] if merged_bwd(call.nq, call.nk, c) else ["dq", "dkv"]
            want = [f"jt_flash_hm_fwd_f32_c{c}"] + [
                f"jt_flash_hm_{k}_f32_c{c}" for k in kinds] * call.grad
        assert how == " + ".join(want), (call, how)
    trainable = [how for call, how in table if isinstance(call, Attn) and call.grad
                 and not how.startswith("eager")]
    # at 224 px mask 1's context (96 tokens) runs eager in the fixed mode
    fixed = 4 if config == "vith16_384.yaml" else 3
    assert len(trainable) == (fixed if mode == "fixed" else 12)


def test_f32_fixture_dispatch():
    """The CPU pretrain fixture (tests/fixtures/pretrain_smoke.yaml: vit_tiny,
    fp32, 32 px and 4 frames, so 8 tokens): every attention runs eager (fewer
    than 128 tokens, in both packages) and the fc1 (K=192) the eager GELU,
    so on the card it launches no kernel; its model and predictor at a real
    geometry are ``test_f32_pretrain_resolves[vit_tiny-96-*]``."""
    cfg = yaml.safe_load((pathlib.Path(__file__).parent / "fixtures"
                          / "pretrain_smoke.yaml").read_text())
    table = [(call, _resolve(call)) for call in _pretrain_calls(cfg)]
    assert table and all(how.startswith("eager") for _, how in table)
    assert all(call.dtype == torch.float32 for call, _ in table)


# (model, predictor width) of vitl16.yaml with vit_small (its 384-wide
# predictor, 6 x 64, and the fixture's 96-wide one, 6 x 16) and vit_base
# (the app's default model; its 384-wide predictor, 12 x 32), in bf16 and
# fp32, fixed and padded
_SMALL_BASE = [(m, w, dt, mode) for m, w in (("vit_small", 384), ("vit_small", 96),
                                            ("vit_base", 384))
               for dt in ("bfloat16", "float32") for mode in ("fixed", "padded")]


@pytest.mark.parametrize("model,pred_width,dtype,mode", _SMALL_BASE,
                         ids=[f"{m}-{w}-{dt}-{mode}" for m, w, dt, mode in _SMALL_BASE])
def test_small_base_pretrain_resolves(model, pred_width, dtype, mode):
    """vitl16.yaml with vit_small or vit_base: every call of the update
    reaches a kernel entry of the dtype or the eager path the JAX package
    takes. The encoders (6 and 12 heads of 64) split token-major: H1 (+ H2
    under a gradient) at c=64, H1-fp32 / H2-fp32 in fp32; the 384-wide
    predictors token-major at c=64 (vit_small) and c=32 (vit_base); the
    96-wide predictor (6 heads of 16, no token-major split) head-major at
    c=16: H4 + H7 at the fixed sequences and the merged rungs, H4 + H5 + H6
    at the padded top rung (1664 tokens); the target's fc1 (K=384, F=1536;
    K=768, F=3072) H3 or H3-fp32."""
    cfg = yaml.safe_load((_CONFIGS / "pretrain" / "vitl16.yaml").read_text())
    cfg["model"].update(pred_embed_dim=pred_width,
                        pred_depth=2 if pred_width == 96 else cfg["model"]["pred_depth"])
    table = [(call, _resolve(call)) for call in _f32_vitl16(mode, model, cfg=cfg, dtype=dtype)]
    for call, how in table:
        print(f"  {model} {pred_width} {dtype} {mode} {call.where:32s} -> {how}")
    f32 = "_f32" if dtype == "float32" else ""
    for call, how in table:
        if how.startswith("eager"):  # fewer than 128 tokens, or an unfused fc1
            assert (isinstance(call, Attn) and call.nq < 128) or (
                isinstance(call, Fc1) and not call.fused), (call, how)
            continue
        if isinstance(call, Fc1):
            assert call.where == "target fc1" and how == f"jt_linear_gelu{f32 or '_bf16'}"
            assert (call.k, call.f) == {"vit_small": (384, 1536), "vit_base": (768, 3072)}[model]
            continue
        if "predictor" in call.where and pred_width == 96:
            kinds = ["dqkv"] if merged_bwd(call.nq, call.nk, 16) else ["dq", "dkv"]
            want = [f"jt_flash_hm_fwd{f32}_c16"] + [f"jt_flash_hm_{k}{f32}_c16" for k in kinds]
        else:
            cp = 32 if "predictor" in call.where and model == "vit_base" else 64
            want = [f"jt_flash_fwd{f32}_c{cp}"]
            want += [f"jt_flash_bwd_{k}{f32}_c{cp}" for k in ("dkv", "dq")] * call.grad
        assert how == " + ".join(want), (call, how)
    hows = " ".join(how for _, how in table)
    if pred_width == 96:  # H7 at the fixed sequences; H5 + H6 at the padded top rung
        assert f"jt_flash_hm_dqkv{f32}_c16" in hows
        assert (f"jt_flash_hm_dq{f32}_c16" in hows) == (mode == "padded")
    trainable = [how for call, how in table if isinstance(call, Attn) and call.grad
                 and not how.startswith("eager")]
    assert len(trainable) == (3 if mode == "fixed" else 12)
