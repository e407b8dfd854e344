"""Zoo ``.pth.tar`` loading and JAX-to-port weight transfer (counterpart of
jepa_tpu/utils/checkpoint_port.py).

The port's modules carry the reference zoo's state_dict names, so a zoo
file loads with ``load_state_dict`` after the reference's rules: prefer
the ``target_encoder`` key with ``encoder`` fallback, strip ``module.`` /
``backbone.`` prefixes, strict by default. ``encoder_state_from_jax`` and
``classifier_state_from_jax`` turn the JAX package's parameter trees (as
numpy: stacked ``[depth, ...]`` block leaves, ``[in, out]`` linears) into
port state_dicts; they take plain dicts and need no JAX.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import numpy as np
import torch

from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, sincos_table

logger = logging.getLogger(__name__)


def strip_prefixes(sd: Mapping[str, object]) -> Dict[str, object]:
    return {k.removeprefix("module.").removeprefix("backbone."): v for k, v in sd.items()}


def load_checkpoint(path: str) -> dict:
    """A ``.pth.tar`` as a dict of tensors and plain values (no arbitrary
    objects are unpickled)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def check_state(sd: Mapping[str, torch.Tensor], model: torch.nn.Module, label: str) -> None:
    """Raise ValueError unless ``sd`` matches ``model``'s keys and shapes."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    bad = [f"{k}: ckpt{tuple(sd[k].shape)} != model{tuple(want[k].shape)}"
           for k in want if k in sd and tuple(sd[k].shape) != tuple(want[k].shape)]
    if missing or extra or bad:
        raise ValueError(
            f"strict {label} load (pass tolerant=True to keep init for "
            f"mismatched entries): missing={missing} unexpected={extra} "
            "shape mismatches:\n  " + "\n  ".join(bad))


def load_pretrained_encoder(
    path: str,
    cfg: ViTCfg,
    checkpoint_key: str = "target_encoder",
    tolerant: bool = False,
    device=None,
) -> VisionTransformer:
    """Load a zoo ``.pth.tar`` encoder into a VisionTransformer on ``device``.

    Strict by default: any missing, unexpected or mis-shaped entry raises,
    except ``pos_embed`` at another grid, which is regenerated at the
    model's grid (it is a non-learned sincos table, so that is exact).
    ``tolerant=True`` keeps a seeded init for mismatched entries instead.
    """
    ckpt = load_checkpoint(path)
    if checkpoint_key in ckpt:
        sd = ckpt[checkpoint_key]
    elif "encoder" in ckpt:
        logger.warning("checkpoint key %r missing; falling back to 'encoder'", checkpoint_key)
        sd = ckpt["encoder"]
    else:
        sd = ckpt  # raw state_dict
    sd = strip_prefixes(sd)
    pe = sincos_table(cfg)
    if "pos_embed" in sd and tuple(sd["pos_embed"].shape) != tuple(pe.shape):
        logger.info("pos_embed ckpt grid %s != model grid %s; regenerating sincos",
                    tuple(sd["pos_embed"].shape), tuple(pe.shape))
        sd["pos_embed"] = pe
    if not tolerant:
        model = VisionTransformer(cfg, device=device)
        check_state(sd, model, "encoder")
        model.load_state_dict(sd, strict=True)
        return model
    gen = torch.Generator().manual_seed(0)
    model = VisionTransformer(cfg).init_weights(gen).to(device)
    want = model.state_dict()
    keep = {k: v for k, v in sd.items()
            if k in want and tuple(v.shape) == tuple(want[k].shape)}
    for k in sorted(set(want) - set(keep)):
        logger.info("encoder: key %s missing or mis-shaped in checkpoint; keeping init", k)
    model.load_state_dict(keep, strict=False)
    return model


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _block_state(blocks: Mapping, i: int, prefix: str) -> Dict[str, torch.Tensor]:
    """Layer i of a stacked JAX block tree -> reference-named entries."""
    g = lambda leaf: np.asarray(leaf, np.float32)[i]
    return {
        f"{prefix}.norm1.weight": _t(g(blocks["ln1"]["scale"])),
        f"{prefix}.norm1.bias": _t(g(blocks["ln1"]["bias"])),
        f"{prefix}.attn.qkv.weight": _t(g(blocks["attn"]["qkv_w"]).T),
        f"{prefix}.attn.qkv.bias": _t(g(blocks["attn"]["qkv_b"])),
        f"{prefix}.attn.proj.weight": _t(g(blocks["attn"]["proj_w"]).T),
        f"{prefix}.attn.proj.bias": _t(g(blocks["attn"]["proj_b"])),
        f"{prefix}.norm2.weight": _t(g(blocks["ln2"]["scale"])),
        f"{prefix}.norm2.bias": _t(g(blocks["ln2"]["bias"])),
        f"{prefix}.mlp.fc1.weight": _t(g(blocks["mlp"]["fc1_w"]).T),
        f"{prefix}.mlp.fc1.bias": _t(g(blocks["mlp"]["fc1_b"])),
        f"{prefix}.mlp.fc2.weight": _t(g(blocks["mlp"]["fc2_w"]).T),
        f"{prefix}.mlp.fc2.bias": _t(g(blocks["mlp"]["fc2_b"])),
    }


def _depth(blocks: Mapping) -> int:
    return int(np.asarray(blocks["ln1"]["scale"]).shape[0])


def encoder_state_from_jax(params: Mapping, consts: Mapping, cfg: ViTCfg) -> Dict[str, torch.Tensor]:
    """JAX encoder (params, consts), as numpy, -> VisionTransformer state_dict
    (the inverse of jepa_tpu's port_encoder)."""
    w = np.asarray(params["patch_embed"]["w"], np.float32)  # [patch_dim, D]
    sd = {
        "patch_embed.proj.weight": _t(w.T.reshape(cfg.patch_kernel_shape)),
        "patch_embed.proj.bias": _t(params["patch_embed"]["b"]),
        "pos_embed": _t(consts["pos_embed"])[None],
    }
    for i in range(_depth(params["blocks"])):
        sd.update(_block_state(params["blocks"], i, f"blocks.{i}"))
    sd["norm.weight"] = _t(params["norm"]["scale"])
    sd["norm.bias"] = _t(params["norm"]["bias"])
    return sd


def classifier_state_from_jax(params: Mapping, acfg) -> Dict[str, torch.Tensor]:
    """JAX attentive classifier, as numpy, -> AttentiveClassifier state_dict
    (the inverse of jepa_tpu's port_attentive_classifier)."""
    pooler = params["pooler"]
    cross = pooler["cross"]
    cp = "pooler.cross_attention_block"
    sd = {
        "pooler.query_tokens": _t(pooler["query_tokens"])[None],
        f"{cp}.norm1.weight": _t(cross["ln1"]["scale"]),
        f"{cp}.norm1.bias": _t(cross["ln1"]["bias"]),
        f"{cp}.xattn.q.weight": _t(np.asarray(cross["q_w"]).T),
        f"{cp}.xattn.q.bias": _t(cross["q_b"]),
        f"{cp}.xattn.kv.weight": _t(np.asarray(cross["kv_w"]).T),
        f"{cp}.xattn.kv.bias": _t(cross["kv_b"]),
        f"{cp}.xattn.proj.weight": _t(np.asarray(cross["proj_w"]).T),
        f"{cp}.xattn.proj.bias": _t(cross["proj_b"]),
        "linear.weight": _t(np.asarray(params["linear"]["w"]).T),
        "linear.bias": _t(params["linear"]["b"]),
    }
    if acfg.complete_block:
        sd.update({
            f"{cp}.norm2.weight": _t(cross["ln2"]["scale"]),
            f"{cp}.norm2.bias": _t(cross["ln2"]["bias"]),
            f"{cp}.mlp.fc1.weight": _t(np.asarray(cross["mlp"]["fc1_w"]).T),
            f"{cp}.mlp.fc1.bias": _t(cross["mlp"]["fc1_b"]),
            f"{cp}.mlp.fc2.weight": _t(np.asarray(cross["mlp"]["fc2_w"]).T),
            f"{cp}.mlp.fc2.bias": _t(cross["mlp"]["fc2_b"]),
        })
    if "blocks" in pooler:
        for i in range(_depth(pooler["blocks"])):
            sd.update(_block_state(pooler["blocks"], i, f"pooler.blocks.{i}"))
    return sd


def load_classifier_state(path: str, checkpoint_key: str = "classifier") -> Dict[str, torch.Tensor]:
    """The probe state_dict of a ``.pth.tar`` (its ``checkpoint_key`` entry,
    or the whole file when that key is absent), prefixes stripped."""
    ckpt = load_checkpoint(path)
    return strip_prefixes(ckpt[checkpoint_key] if checkpoint_key in ckpt else ckpt)

