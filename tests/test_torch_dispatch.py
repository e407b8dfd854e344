"""The shipped-config dispatch table: for each of the 3 pretrain and 15 eval
YAMLs in configs/ (the evals in both use_bfloat16 settings), every
attention and fc1 call shape the port's path makes, resolved through the
port's own dispatch rules (resolve_flash, padded_head_dim, the kernels'
head dims, fused_tiling, the kernels' k panels) on a stand-in for a CUDA
tensor. Each call must reach a kernel instance that exists (a C entry the
build binds and a source defines: H1 by head dim and dtype, H2 for a
differentiated H1, H3 by K/F tiling and dtype) or the documented eager
path: attention with fewer than 128 queries or keys (the probe's 1-query
cross-attention, short contexts), and the differentiated fc1 (probe,
context encoder, predictor). No model runs. ``pytest -s`` prints the table.

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
from jepa_tpu_torch.ops.flash_attention import F32_HEAD_DIMS, KERNEL_HEAD_DIMS, padded_head_dim
from jepa_tpu_torch.ops.fused_mlp import _KERNEL_K_STEP, fused_tiling, resolve_fused_mlp

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


def _pretrain_calls(cfg):
    m, d = cfg["model"], cfg["data"]
    dt = _DTYPES[str(cfg["meta"].get("dtype", "bfloat16"))]
    enc = vit_cfg(m["model_name"], img_size=d["crop_size"], patch_size=d["patch_size"],
                  num_frames=d["num_frames"], tubelet_size=d["tubelet_size"],
                  uniform_power=m["uniform_power"], compute_dtype=dt)
    pred = predictor_cfg_for(enc, predictor_embed_dim=m["pred_embed_dim"], depth=m["pred_depth"],
                             num_mask_tokens=len(cfg["mask"]))
    grid = MaskGrid.from_data_cfg(d["crop_size"], d["patch_size"], d["num_frames"],
                                  d["tubelet_size"])
    keep = [calibrate_keep_counts(MaskSpec.from_cfg(x), grid, d["batch_size"])
            for x in cfg["mask"]]
    n, b = enc.num_patches, d["batch_size"] * d.get("num_clips", 1)
    c, pc = enc.embed_dim // enc.num_heads, pred.predictor_embed_dim // pred.num_heads
    calls = [Attn("target self-attn", n, n, enc.num_heads, c, dt),
             Fc1("target fc1", b * n, enc.embed_dim, enc.mlp_hidden, dt, True)]
    for i, (ke, kp) in enumerate(keep):
        calls += [Attn(f"mask {i} context self-attn", ke, ke, enc.num_heads, c, dt, True),
                  Fc1(f"mask {i} context fc1", b * ke, enc.embed_dim, enc.mlp_hidden, dt, False),
                  Attn(f"mask {i} predictor self-attn", ke + kp, ke + kp, pred.num_heads, pc,
                       dt, True),
                  Fc1(f"mask {i} predictor fc1", b * (ke + kp), pred.predictor_embed_dim,
                      int(pred.predictor_embed_dim * pred.mlp_ratio), dt, False)]
    return calls


def _resolve(call):
    """The kernel entries (or the eager path) a call resolves to; asserts
    the entries exist."""
    if isinstance(call, Attn):
        if call.cross or not resolve_flash("auto", call.nq, call.nk, _CARD):
            # separate q/k/v and short sequences run xla_attention, as the JAX
            # package runs them in XLA ('auto' needs nq, nk >= 128)
            assert min(call.nq, call.nk) < 128, call
            return "eager xla_attention"
        cp = padded_head_dim(call.c)
        if call.dtype == torch.bfloat16:
            assert cp in KERNEL_HEAD_DIMS, call
            entries = [f"jt_flash_fwd_c{cp}"]
            if call.grad:  # FlashSelfAttentionFn: H2 for the backward
                entries += [f"jt_flash_bwd_dkv_c{cp}", f"jt_flash_bwd_dq_c{cp}"]
        else:
            assert cp in F32_HEAD_DIMS and not call.grad, call
            entries = [f"jt_flash_fwd_f32_c{cp}"]
    else:
        if not call.fused:
            return "eager linear + GELU (differentiated)"
        assert resolve_fused_mlp(_CARD) and fused_tiling(call.m, call.k, call.f), call
        assert call.k % _KERNEL_K_STEP[call.dtype] == 0 and call.f % 128 == 0, call
        entries = ["jt_linear_gelu_bf16" if call.dtype == torch.bfloat16
                   else "jt_linear_gelu_f32"]
    for e in entries:
        assert e in _build._SIGNATURES and e in _ENTRIES, (call, e)
    return " + ".join(entries)


_CASES = ([(p.name, None) for p in sorted((_CONFIGS / "pretrain").glob("*.yaml"))]
          + [(p.name, bf16) for p in sorted((_CONFIGS / "evals").glob("*.yaml"))
             for bf16 in (True, False)])


def test_shipped_configs_are_all_listed():
    assert len([c for c in _CASES if c[1] is None]) == 3
    assert len([c for c in _CASES if c[1] is not None]) == 2 * 15


@pytest.mark.parametrize("name,bf16", _CASES,
                         ids=[f"{n}-{'pretrain' if b is None else ('bf16' if b else 'fp32')}"
                              for n, b in _CASES])
def test_shipped_config_dispatch(name, bf16):
    kind = "pretrain" if bf16 is None else "evals"
    cfg = yaml.safe_load((_CONFIGS / kind / name).read_text())
    calls = _pretrain_calls(cfg) if bf16 is None else _eval_calls(cfg, bf16)
    table = [(call, _resolve(call)) for call in calls]
    print(f"\n{kind}/{name}" + ("" if bf16 is None else f" use_bfloat16={bf16}"))
    for call, how in table:
        shape = (f"nq={call.nq} nk={call.nk} H={call.heads} c={call.c}"
                 if isinstance(call, Attn) else f"M={call.m} K={call.k} F={call.f}")
        print(f"  {call.where:32s} {shape:34s} {str(call.dtype)[6:]:8s} -> {how}")
    # every shipped path runs the encoder's attention and fc1 through kernels
    assert all(how.startswith("jt_") for call, how in table
               if "encoder" in call.where or "target" in call.where)
