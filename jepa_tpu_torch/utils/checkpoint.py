"""Training checkpoints as the reference's ``.pth.tar`` (counterpart of
jepa_tpu/utils/checkpoint.py, which writes orbax; reference
app/vjepa/train.py:328-346).

Layout: ``<folder>/<tag>-latest.pth.tar`` and, every ``save_every_freq``
epochs, ``<folder>/<tag>-e<epoch>.pth.tar``, each a dict with the
reference's keys: ``encoder``, ``predictor``, ``target_encoder`` (module
state_dicts with the zoo's names), ``opt`` (``step`` and the AdamW
moments ``mu`` / ``nu`` keyed like ``TrainState.named_params``),
``epoch``, ``batch_size``, ``world_size``, ``lr``. So
``jepa_tpu_torch.api.load_encoder(path, checkpoint_key="target_encoder")``
reads the app's own checkpoint. Files are written to a temporary name and
renamed, so a crash mid-write never leaves a truncated ``-latest``.
Schedules are pure functions of the step, so a resume replays nothing.

The frozen evals' probe checkpoints (``save_probe_checkpoint``) use the
same naming and atomic write and hold what the JAX evals save:
``classifier`` (the AttentiveClassifier state_dict, which
``api.load_classifier`` reads), ``opt`` (``step`` and the AdamW moments
keyed by parameter name) and ``epoch``.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def checkpoint_path(folder: str, tag: str, epoch: Optional[int] = None) -> str:
    """``<folder>/<tag>-latest.pth.tar``, or the snapshot of ``epoch``."""
    name = f"{tag}-latest.pth.tar" if epoch is None else f"{tag}-e{epoch}.pth.tar"
    return os.path.join(os.path.abspath(folder), name)


def _save_atomic(obj: dict, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(folder: str, tag: str, state, epoch: int, save_every_freq: int = -1,
                    batch_size: Optional[int] = None, world_size: int = 1,
                    lr: Optional[float] = None) -> None:
    """Write ``<tag>-latest.pth.tar`` (and the epoch snapshot every
    ``save_every_freq`` epochs) from a ``TrainState``."""
    obj = {
        "encoder": state.encoder.state_dict(),
        "predictor": state.predictor.state_dict(),
        "target_encoder": state.target.state_dict(),
        "opt": {"step": int(state.step), "mu": state.mu, "nu": state.nu},
        "epoch": int(epoch),
        "batch_size": batch_size,
        "world_size": world_size,
        "lr": lr,
    }
    _save_atomic(obj, checkpoint_path(folder, tag))
    if save_every_freq > 0 and epoch % save_every_freq == 0:
        snap = checkpoint_path(folder, tag, epoch)
        if not os.path.exists(snap):
            _save_atomic(obj, snap)
    logger.info("saved checkpoint at epoch %d", epoch)


def _restore_moments(path: str, opt: dict, state) -> None:
    """Copy the saved AdamW moments ``opt['mu']`` / ``opt['nu']`` into
    ``state.mu`` / ``state.nu`` in place; their names must match."""
    with torch.no_grad():
        for moments, saved in ((state.mu, opt["mu"]), (state.nu, opt["nu"])):
            if set(moments) != set(saved):
                raise ValueError(f"{path}: optimizer moments do not match the model")
            for name, t in moments.items():
                t.copy_(saved[name])


def load_checkpoint(folder: str, tag: str, state,
                    read_path: Optional[str] = None) -> Tuple[object, int]:
    """Restore params, target, moments and step into ``state`` in place;
    returns (state, start epoch). A missing or unreadable file leaves the
    state as it is and returns epoch 0, as the reference does."""
    path = read_path or checkpoint_path(folder, tag)
    if not os.path.exists(path):
        logger.info("no checkpoint at %s; starting fresh", path)
        return state, 0
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, pickle.UnpicklingError) as e:
        logger.warning("failed to load checkpoint %s: %s", path, e)
        return state, 0
    state.encoder.load_state_dict(ckpt["encoder"])
    state.predictor.load_state_dict(ckpt["predictor"])
    state.target.load_state_dict(ckpt["target_encoder"])
    _restore_moments(path, ckpt["opt"], state)
    state.step = int(ckpt["opt"]["step"])
    epoch = int(ckpt["epoch"])
    logger.info("restored checkpoint from %s (epoch %d)", path, epoch)
    return state, epoch


def save_probe_checkpoint(folder: str, tag: str, probe, epoch: int) -> None:
    """Write ``<tag>-latest.pth.tar`` from an eval probe (an object with
    ``classifier``, ``mu``, ``nu`` and ``step``)."""
    obj = {
        "classifier": probe.classifier.state_dict(),
        "opt": {"step": int(probe.step), "mu": probe.mu, "nu": probe.nu},
        "epoch": int(epoch),
    }
    _save_atomic(obj, checkpoint_path(folder, tag))
    logger.info("saved probe checkpoint at epoch %d", epoch)


def load_probe_checkpoint(folder: str, tag: str, probe) -> int:
    """Restore the classifier, its moments and step into ``probe`` in
    place; returns the start epoch (0 when there is no checkpoint)."""
    path = checkpoint_path(folder, tag)
    if not os.path.exists(path):
        logger.info("no probe checkpoint at %s; starting fresh", path)
        return 0
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    probe.classifier.load_state_dict(ckpt["classifier"])
    _restore_moments(path, ckpt["opt"], probe)
    probe.step = int(ckpt["opt"]["step"])
    epoch = int(ckpt["epoch"])
    logger.info("restored probe checkpoint from %s (epoch %d)", path, epoch)
    return epoch
