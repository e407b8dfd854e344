"""Zoo ``.pth.tar`` loading and JAX-to-port weight transfer (counterpart of
jepa_tpu/utils/checkpoint_port.py).

The port's modules carry the reference zoo's state_dict names, so a zoo
file loads with ``load_state_dict`` after the reference's rules: prefer
the ``target_encoder`` key with ``encoder`` fallback, strip ``module.`` /
``backbone.`` prefixes, strict by default. ``encoder_state_from_jax`` and
``classifier_state_from_jax`` turn the JAX package's parameter trees (as
numpy: stacked ``[depth, ...]`` block leaves, ``[in, out]`` linears) into
port state_dicts; they take plain dicts and need no JAX.
``predictor_state_from_jax`` does the same for the predictor, and
``train_state_from_jax`` turns a whole JAX train state (params, target,
AdamW moments, step) into the port's ``TrainState``.

The ``*_to_jax`` functions are their inverses: port state_dicts (and a
whole ``TrainState``, moments and step included) to the JAX package's
canonical stacked layout as numpy, which ``utils.orbax.save_tree`` writes
as the JAX package's own checkpoint. ``pos_embed`` is a const the JAX
package derives from the config, so no tree holds it. The ``*_template``
functions give the layout's shapes (nested dicts of shape tuples, built
on the meta device) for ``utils.orbax.load_subtree``; ``load_orbax_encoder``
and ``load_orbax_classifier`` read an orbax checkpoint's encoder or probe
strictly, as jepa_tpu/api.py does.
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
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of an orbax checkpoint
        return a.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _block_state(blocks: Mapping, i: int, prefix: str) -> Dict[str, torch.Tensor]:
    """Layer i of a stacked JAX block tree -> reference-named entries."""
    g = lambda leaf: (leaf[i].float().numpy() if isinstance(leaf, torch.Tensor)
                      else np.asarray(leaf[i], np.float32))
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
    return int(blocks["ln1"]["scale"].shape[0])


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


def predictor_state_from_jax(params: Mapping, consts: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX predictor (params, consts), as numpy, -> Predictor state_dict
    (the inverse of jepa_tpu's port_predictor)."""
    sd = {
        "predictor_embed.weight": _t(np.asarray(params["predictor_embed"]["w"]).T),
        "predictor_embed.bias": _t(params["predictor_embed"]["b"]),
        "predictor_pos_embed": _t(consts["pos_embed"])[None],
        "predictor_norm.weight": _t(params["norm"]["scale"]),
        "predictor_norm.bias": _t(params["norm"]["bias"]),
        "predictor_proj.weight": _t(np.asarray(params["predictor_proj"]["w"]).T),
        "predictor_proj.bias": _t(params["predictor_proj"]["b"]),
    }
    for i in range(_depth(params["blocks"])):
        sd.update(_block_state(params["blocks"], i, f"predictor_blocks.{i}"))
    if cfg.use_mask_tokens:
        mts = np.asarray(params["mask_tokens"], np.float32)
        for k in range(cfg.num_mask_tokens):
            sd[f"mask_tokens.{k}"] = _t(mts[k].reshape(1, 1, -1))
    return sd


def train_state_from_jax(state: Mapping, consts: Mapping, enc_cfg, pred_cfg,
                         device="cuda"):
    """The JAX package's train state (canonical stacked layout, as numpy:
    ``step``, ``params`` {encoder, predictor}, ``target``, ``opt`` {mu, nu})
    -> the port's TrainState on ``device``, so both packages update from
    the same numbers."""
    from jepa_tpu_torch.api import _resolve_device
    from jepa_tpu_torch.models.predictor import Predictor
    from jepa_tpu_torch.train.step import state_from_modules

    dev = _resolve_device(device)
    ec, pc = consts["encoder"], consts["predictor"]

    def modules(tree):
        enc = VisionTransformer(enc_cfg, device=dev)
        enc.load_state_dict(encoder_state_from_jax(tree["encoder"], ec, enc_cfg))
        pred = Predictor(pred_cfg, device=dev)
        pred.load_state_dict(predictor_state_from_jax(tree["predictor"], pc, pred_cfg))
        return enc, pred

    def moments(tree):
        enc, pred = modules(tree)
        out = {f"encoder.{n}": p.detach() for n, p in enc.named_parameters()}
        out.update({f"predictor.{n}": p.detach() for n, p in pred.named_parameters()})
        return out

    encoder, predictor = modules(state["params"])
    target = VisionTransformer(enc_cfg, device=dev)
    target.load_state_dict(encoder_state_from_jax(state["target"], ec, enc_cfg))
    return state_from_modules(encoder, predictor, target, step=int(state["step"]),
                              mu=moments(state["opt"]["mu"]),
                              nu=moments(state["opt"]["nu"]))


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



# ---- the port -> the JAX package's layout ----------------------------------
# Each *_tree builds the JAX layout as torch tensors, so the same code runs
# on real state (``*_to_jax``, then numpy) and on meta tensors (the shape
# templates).

def _stacked_blocks(sd: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """The blocks ``{prefix}.{i}.*`` stacked on a leading depth axis, with
    the linears as [in, out] (the inverse of ``_block_state``)."""
    depth = sum(1 for k in sd if k.startswith(f"{prefix}.") and k.endswith(".norm1.weight"))
    g = lambda name: torch.stack([sd[f"{prefix}.{i}.{name}"] for i in range(depth)])
    gt = lambda name: torch.stack([sd[f"{prefix}.{i}.{name}"].T for i in range(depth)])
    return {
        "ln1": {"scale": g("norm1.weight"), "bias": g("norm1.bias")},
        "attn": {"qkv_w": gt("attn.qkv.weight"), "qkv_b": g("attn.qkv.bias"),
                 "proj_w": gt("attn.proj.weight"), "proj_b": g("attn.proj.bias")},
        "ln2": {"scale": g("norm2.weight"), "bias": g("norm2.bias")},
        "mlp": {"fc1_w": gt("mlp.fc1.weight"), "fc1_b": g("mlp.fc1.bias"),
                "fc2_w": gt("mlp.fc2.weight"), "fc2_b": g("mlp.fc2.bias")},
    }


def _encoder_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    w = sd["patch_embed.proj.weight"]
    return {
        "patch_embed": {"w": w.reshape(w.shape[0], -1).T, "b": sd["patch_embed.proj.bias"]},
        "blocks": _stacked_blocks(sd, "blocks"),
        "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
    }


def _predictor_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    tree = {
        "predictor_embed": {"w": sd["predictor_embed.weight"].T,
                            "b": sd["predictor_embed.bias"]},
        "blocks": _stacked_blocks(sd, "predictor_blocks"),
        "norm": {"scale": sd["predictor_norm.weight"], "bias": sd["predictor_norm.bias"]},
        "predictor_proj": {"w": sd["predictor_proj.weight"].T, "b": sd["predictor_proj.bias"]},
    }
    tokens = sorted((k for k in sd if k.startswith("mask_tokens.")),
                    key=lambda k: int(k.split(".")[1]))
    if tokens:
        tree["mask_tokens"] = torch.stack([sd[k].reshape(-1) for k in tokens])
    return tree


def _classifier_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    cp = "pooler.cross_attention_block"
    cross = {
        "ln1": {"scale": sd[f"{cp}.norm1.weight"], "bias": sd[f"{cp}.norm1.bias"]},
        "q_w": sd[f"{cp}.xattn.q.weight"].T, "q_b": sd[f"{cp}.xattn.q.bias"],
        "kv_w": sd[f"{cp}.xattn.kv.weight"].T, "kv_b": sd[f"{cp}.xattn.kv.bias"],
        "proj_w": sd[f"{cp}.xattn.proj.weight"].T, "proj_b": sd[f"{cp}.xattn.proj.bias"],
    }
    if f"{cp}.norm2.weight" in sd:  # complete_block
        cross["ln2"] = {"scale": sd[f"{cp}.norm2.weight"], "bias": sd[f"{cp}.norm2.bias"]}
        cross["mlp"] = {"fc1_w": sd[f"{cp}.mlp.fc1.weight"].T, "fc1_b": sd[f"{cp}.mlp.fc1.bias"],
                        "fc2_w": sd[f"{cp}.mlp.fc2.weight"].T, "fc2_b": sd[f"{cp}.mlp.fc2.bias"]}
    pooler = {"query_tokens": sd["pooler.query_tokens"][0], "cross": cross}
    if any(k.startswith("pooler.blocks.") for k in sd):
        pooler["blocks"] = _stacked_blocks(sd, "pooler.blocks")
    return {"pooler": pooler, "linear": {"w": sd["linear.weight"].T, "b": sd["linear.bias"]}}


def _numpy(tree):
    """A tree of tensors as float32 numpy arrays of their own (bit-equal for
    fp32; never a view of a live parameter)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32, copy=True).contiguous().numpy()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _split_moments(moments: Mapping[str, torch.Tensor]):
    """"encoder.<n>" / "predictor.<n>" keyed moments -> two state_dicts."""
    enc = {k[len("encoder."):]: v for k, v in moments.items() if k.startswith("encoder.")}
    pred = {k[len("predictor."):]: v for k, v in moments.items() if k.startswith("predictor.")}
    return enc, pred


def encoder_state_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """VisionTransformer state_dict -> the JAX encoder's params as numpy
    (the inverse of ``encoder_state_from_jax``; ``pos_embed`` is dropped)."""
    return _numpy(_encoder_tree(strip_prefixes(sd)))


def predictor_state_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Predictor state_dict -> the JAX predictor's params as numpy."""
    return _numpy(_predictor_tree(sd))


def classifier_state_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """AttentiveClassifier state_dict -> the JAX probe's params as numpy."""
    return _numpy(_classifier_tree(strip_prefixes(sd)))


def train_state_to_jax(state) -> dict:
    """The port's TrainState (whole moments, as a 1-rank run or
    ``checkpoint.gather_moments`` holds them) -> the JAX package's train
    state as numpy: ``step`` (int32), ``params`` {encoder, predictor},
    ``target`` and ``opt`` {mu, nu} (the inverse of ``train_state_from_jax``)."""
    def params(enc_sd, pred_sd):
        return {"encoder": _numpy(_encoder_tree(enc_sd)),
                "predictor": _numpy(_predictor_tree(pred_sd))}

    return {
        "step": np.asarray(int(state.step), np.int32),
        "params": params(state.encoder.state_dict(), state.predictor.state_dict()),
        "target": _numpy(_encoder_tree(state.target.state_dict())),
        "opt": {"mu": params(*_split_moments(state.mu)),
                "nu": params(*_split_moments(state.nu))},
    }


def encoder_template(cfg: ViTCfg) -> dict:
    """The JAX encoder params' shapes for ``cfg``."""
    return _shapes(_encoder_tree(VisionTransformer(cfg, device="meta").state_dict()))


def predictor_template(cfg) -> dict:
    from jepa_tpu_torch.models.predictor import Predictor

    return _shapes(_predictor_tree(Predictor(cfg, device="meta").state_dict()))


def classifier_template(acfg) -> dict:
    from jepa_tpu_torch.models.attentive import AttentiveClassifier

    return _shapes(_classifier_tree(AttentiveClassifier(acfg, device="meta").state_dict()))


def train_state_template(enc_cfg: ViTCfg, pred_cfg) -> dict:
    """The JAX train state's shapes (``init_train_state``'s stacked layout)."""
    params = {"encoder": encoder_template(enc_cfg), "predictor": predictor_template(pred_cfg)}
    return {"step": (), "params": params, "target": params["encoder"],
            "opt": {"mu": params, "nu": params}}


# checkpoint_key -> where the JAX package's orbax run directory keeps it
# (jepa_tpu/evals/video_classification_frozen.py::_load_encoder)
_ORBAX_ENCODER = {"target_encoder": ("target",), "encoder": ("params", "encoder")}


def load_orbax_encoder(path: str, cfg: ViTCfg, checkpoint_key: str = "target_encoder",
                       device=None) -> VisionTransformer:
    """The encoder of a JAX orbax checkpoint (``target`` for
    'target_encoder', ``params/encoder`` for 'encoder') in a
    VisionTransformer on ``device``, strictly: a missing leaf raises
    KeyError, a shape mismatch ValueError."""
    from jepa_tpu_torch.utils import orbax

    keys = _ORBAX_ENCODER.get(checkpoint_key, ("target",))
    template = encoder_template(cfg)
    for k in reversed(keys):
        template = {k: template}
    tree = orbax.load_subtree(path, template)
    for k in keys:
        tree = tree[k]
    sd = encoder_state_from_jax(tree, {"pos_embed": sincos_table(cfg)[0]}, cfg)
    model = VisionTransformer(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    return model


def load_orbax_classifier(path: str, acfg, device=None):
    """The ``classifier`` entry of a JAX eval's orbax probe checkpoint in an
    AttentiveClassifier on ``device``, strictly."""
    from jepa_tpu_torch.models.attentive import AttentiveClassifier
    from jepa_tpu_torch.utils import orbax

    tree = orbax.load_subtree(path, {"classifier": classifier_template(acfg)})["classifier"]
    clf = AttentiveClassifier(acfg, device=device)
    clf.load_state_dict(classifier_state_from_jax(tree, acfg), strict=True)
    return clf
