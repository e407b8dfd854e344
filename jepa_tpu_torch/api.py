"""Inference API: load a frozen V-JEPA encoder (and an attentive probe) and
serve features or class probabilities (counterpart of jepa_tpu/api.py).

    from jepa_tpu_torch.api import load_encoder, load_classifier

    enc = load_encoder("vitl16.pth.tar", "vit_large", num_frames=16,
                       uniform_power=True)          # device="cuda"
    feats = enc.encode(clips)     # [B, T, H, W, C] uint8 or float -> [B, N, D] fp32
    clf = load_classifier("k400-probe.pth.tar", enc, num_classes=400)
    probs = clf.classify(clips)   # [B, num_classes] fp32

A checkpoint is a reference zoo ``.pth.tar`` (or the port's own) or a
JAX package's orbax directory (its pretraining run or eval probe, read
without JAX by ``utils.orbax``). The encoder runs
grad-free with the fused fc1 kernel on: on a CUDA device every encoder
block runs the flash-attention kernel (H1) and the fused fc1 + GELU
kernel (H3). ``device`` defaults to "cuda" and a missing GPU raises; the
work never moves to the CPU unasked (tests pass ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from jepa_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from jepa_tpu_torch.models.attentive import (
    AttentiveCfg,
    AttentiveClassifier,
    classifier_forward,
)
from jepa_tpu_torch.models.factory import vit_cfg
from jepa_tpu_torch.models.transformer import cast_matmul_weights_
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, vit_forward
from jepa_tpu_torch.utils import orbax
from jepa_tpu_torch.utils.checkpoint_port import (
    check_state,
    load_classifier_state,
    load_orbax_classifier,
    load_orbax_encoder,
    load_pretrained_encoder,
)

_TORCH_CKPT = (".pth.tar", ".pth", ".pt")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def checkpoint_format(path: str) -> str:
    """'torch' for a ``.pth.tar`` / ``.pth`` / ``.pt`` file, 'orbax' for an
    orbax checkpoint directory (one with ``_METADATA``); anything else
    raises ValueError."""
    if path.endswith(_TORCH_CKPT):
        return "torch"
    if orbax.is_checkpoint(path):
        return "orbax"
    raise ValueError(f"{path!r} is neither a .pth.tar / .pth / .pt file nor an orbax "
                     f"checkpoint directory (one with {orbax.METADATA})")


@dataclasses.dataclass
class Encoder:
    """A loaded, frozen encoder."""

    model: VisionTransformer
    cfg: ViTCfg

    def __post_init__(self):
        self.model.requires_grad_(False).eval()
        self._run_cfg = dataclasses.replace(self.cfg, fused_mlp=True)  # grad-free

    @property
    def device(self) -> torch.device:
        return self.model.pos_embed.device

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim

    @torch.no_grad()
    def encode(self, clips, normalize: Optional[bool] = None) -> torch.Tensor:
        """clips: video [B, T, H, W, C] or image [B, H, W, C] (array or
        tensor). uint8 input is scaled and ImageNet-normalized (``normalize``
        overrides the dtype-based default). Returns [B, N, D] fp32 on the
        encoder's device."""
        x = torch.as_tensor(clips).to(self.device)
        if normalize is None:
            normalize = x.dtype == torch.uint8
        if normalize:
            mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
            std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
            x = (x.float() / 255.0 - mean) / std
        x = x.to(self.cfg.compute_dtype)
        return vit_forward(self.model, x, self._run_cfg).float()


def load_encoder(
    checkpoint: str,
    model_name: str,
    img_size: int = 224,
    patch_size: Optional[int] = None,
    num_frames: int = 1,
    tubelet_size: int = 2,
    uniform_power: bool = False,
    checkpoint_key: str = "target_encoder",
    compute_dtype: torch.dtype = torch.bfloat16,
    tolerant: bool = False,
    device="cuda",
) -> Encoder:
    """Load a frozen encoder from a reference ``.pth.tar`` zoo file or a
    JAX orbax checkpoint directory.

    ``checkpoint_key`` is 'target_encoder' or 'encoder' (in an orbax
    directory: ``target`` or ``params/encoder``). Loading is strict by
    default: a key or shape mismatch raises; ``tolerant=True`` keeps a
    seeded init for mismatched entries of a ``.pth.tar`` (an orbax
    directory always loads strictly, as in the JAX package).
    """
    if checkpoint_key not in ("target_encoder", "encoder"):
        raise ValueError(f"checkpoint_key must be 'target_encoder' or 'encoder', "
                         f"got {checkpoint_key!r}")
    device = _resolve_device(device)
    fmt = checkpoint_format(checkpoint)
    cfg = vit_cfg(model_name, img_size=img_size, patch_size=patch_size,
                  num_frames=num_frames, tubelet_size=tubelet_size,
                  uniform_power=uniform_power, compute_dtype=compute_dtype)
    if fmt == "orbax":
        model = load_orbax_encoder(checkpoint, cfg, checkpoint_key, device=device)
    else:
        model = load_pretrained_encoder(checkpoint, cfg, checkpoint_key,
                                        tolerant=tolerant, device=device)
    return Encoder(model=cast_matmul_weights_(model, compute_dtype), cfg=cfg)


@dataclasses.dataclass
class VideoClassifier:
    """A frozen encoder plus a trained attentive probe. ``classify`` returns
    fp32 softmax probabilities [B, num_classes]; for the multi-view eval
    protocol call it per view and average."""

    encoder: Encoder
    classifier: AttentiveClassifier
    acfg: AttentiveCfg

    def __post_init__(self):
        self.classifier.requires_grad_(False).eval()

    @torch.no_grad()
    def classify(self, clips, normalize: Optional[bool] = None) -> torch.Tensor:
        feats = self.encoder.encode(clips, normalize)  # fp32, as the evals feed it
        logits = classifier_forward(self.classifier, feats, self.acfg)
        return torch.softmax(logits, dim=-1)

    @property
    def num_classes(self) -> int:
        return self.acfg.num_classes


def load_classifier(
    checkpoint: str,
    encoder: Encoder,
    num_classes: int,
    depth: int = 1,
    checkpoint_key: str = "classifier",
) -> VideoClassifier:
    """Load a trained attentive probe on top of a loaded encoder, strictly:
    a key or shape mismatch raises. A ``.pth.tar`` (reference layout) gives
    its ``checkpoint_key`` entry; a JAX eval's orbax probe directory its
    ``classifier`` tree. ``depth`` must match the probe's training config
    (the evals use 1)."""
    fmt = checkpoint_format(checkpoint)
    cd = encoder.cfg.compute_dtype
    acfg = AttentiveCfg(embed_dim=encoder.cfg.embed_dim, num_heads=encoder.cfg.num_heads,
                        depth=depth, num_classes=num_classes, compute_dtype=cd)
    if fmt == "orbax":
        clf = load_orbax_classifier(checkpoint, acfg, device=encoder.device)
    else:
        sd = load_classifier_state(checkpoint, checkpoint_key)
        clf = AttentiveClassifier(acfg, device=encoder.device)
        check_state(sd, clf, "classifier")
        clf.load_state_dict(sd, strict=True)
    return VideoClassifier(encoder=encoder, classifier=cast_matmul_weights_(clf, cd),
                           acfg=acfg)
