"""What the benchmark takes from the port: its modules, looked up when a
cell is set up (so a test can plant a fault underneath), and the leaves of
the seed's weights copied into the port's modules."""

from __future__ import annotations

import importlib

import torch


def port(name: str):
    """jepa_tpu_torch.<name>."""
    return importlib.import_module(f"jepa_tpu_torch.{name}")


def load_leaves(module: torch.nn.Module, leaves, label: str) -> None:
    """Copy the benchmark's leaves into a module's parameters, every one."""
    params = dict(module.named_parameters())
    if set(params) != set(leaves):
        raise RuntimeError(f"{label}: the program's parameters {sorted(set(params) ^ set(leaves))}"
                           " differ from the configuration's")
    with torch.no_grad():
        for k, p in params.items():
            if tuple(p.shape) != tuple(leaves[k].shape):
                raise RuntimeError(f"{label}.{k}: shape {tuple(p.shape)} vs "
                                   f"{tuple(leaves[k].shape)}")
            p.copy_(leaves[k])


def check_dims(cfg_obj, m: dict, label: str) -> None:
    """The program's config for the model name must have the file's widths."""
    got = dict(embed_dim=cfg_obj.embed_dim, depth=cfg_obj.depth, num_heads=cfg_obj.num_heads,
               mlp_ratio=cfg_obj.mlp_ratio)
    want = {k: m[k] for k in got}
    if got != want:
        raise RuntimeError(f"{label}: the program builds {got}, the configuration states {want}")
