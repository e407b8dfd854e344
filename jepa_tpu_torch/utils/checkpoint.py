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

Data-parallel runs (a ``parallel.mesh.Layout``): every rank calls
``save_checkpoint``; only rank 0 writes, and a barrier follows. Under
ZeRO-1 (fsdp > 1) the moments' slices are gathered first, so the file
keeps the layout above and a 1-rank run, or one with another fsdp,
resumes from it; on load every rank reads the file and keeps its slices.

``meta.read_checkpoint`` may also name a JAX pretraining run's orbax
directory (jepa_tpu/utils/checkpoint.py's ``<tag>-latest``): the train
state and its epoch are read without JAX (``utils.orbax``) and go through
``checkpoint_port.train_state_from_jax``, so a run moves from the JAX
package to the port. The port still writes ``.pth.tar``.

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

from jepa_tpu_torch.parallel import dist as pdist
from jepa_tpu_torch.parallel.mesh import Layout, shard, zero1_plan
from jepa_tpu_torch.utils import orbax
from jepa_tpu_torch.utils.checkpoint_port import train_state_from_jax, train_state_template

logger = logging.getLogger(__name__)


def checkpoint_path(folder: str, tag: str, epoch: Optional[int] = None) -> str:
    """``<folder>/<tag>-latest.pth.tar``, or the snapshot of ``epoch``."""
    name = f"{tag}-latest.pth.tar" if epoch is None else f"{tag}-e{epoch}.pth.tar"
    return os.path.join(os.path.abspath(folder), name)


def _save_atomic(obj: dict, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def gather_moments(state, layout: Layout):
    """(mu, nu) of ``state`` whole: the ZeRO-1 slices all-gathered over the
    fsdp group (``state.mu`` / ``state.nu`` themselves at fsdp 1)."""
    if layout.fsdp == 1:
        return state.mu, state.nu
    plan = zero1_plan(state.named_params(), layout.fsdp, layout.min_size_to_shard)
    names = [n for n, ax in plan.items() if ax is not None]
    parts = pdist.all_gather([state.mu[n] for n in names] + [state.nu[n] for n in names],
                             group=layout.fsdp_group)
    mu, nu = dict(state.mu), dict(state.nu)
    for j, n in enumerate(names):
        mu[n] = torch.cat([p[j] for p in parts], dim=plan[n])
        nu[n] = torch.cat([p[len(names) + j] for p in parts], dim=plan[n])
    return mu, nu


def save_checkpoint(folder: str, tag: str, state, epoch: int, save_every_freq: int = -1,
                    batch_size: Optional[int] = None, world_size: int = 1,
                    lr: Optional[float] = None, layout: Optional[Layout] = None) -> None:
    """Write ``<tag>-latest.pth.tar`` (and the epoch snapshot every
    ``save_every_freq`` epochs) from a ``TrainState``; with a ``layout``
    every rank must call it (rank 0 writes)."""
    layout = layout or Layout()
    mu, nu = gather_moments(state, layout)
    if layout.rank == 0:
        obj = {
            "encoder": state.encoder.state_dict(),
            "predictor": state.predictor.state_dict(),
            "target_encoder": state.target.state_dict(),
            "opt": {"step": int(state.step), "mu": mu, "nu": nu},
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
    pdist.barrier()


def _restore_moments(path: str, opt: dict, state, plan=None, layout=None) -> None:
    """Copy the saved AdamW moments ``opt['mu']`` / ``opt['nu']`` into
    ``state.mu`` / ``state.nu`` in place; their names must match. With a
    ZeRO-1 ``plan`` (name -> shard axis) each rank keeps its slices."""
    with torch.no_grad():
        for moments, saved in ((state.mu, opt["mu"]), (state.nu, opt["nu"])):
            if set(moments) != set(saved):
                raise ValueError(f"{path}: optimizer moments do not match the model")
            for name, t in moments.items():
                t.copy_(saved[name] if plan is None else shard(saved[name], plan[name], layout))


def _read_orbax(path: str, state) -> Tuple[dict, int]:
    """A JAX train state's orbax directory as a ``.pth.tar``'s entries
    (state_dicts, ``opt``) on the CPU, and its epoch."""
    enc_cfg, pred_cfg = state.encoder.cfg, state.predictor.cfg
    template = train_state_template(enc_cfg, pred_cfg)
    template["epoch"] = ()
    tree = orbax.load_subtree(path, template)
    consts = {"encoder": {"pos_embed": state.encoder.pos_embed[0]},
              "predictor": {"pos_embed": state.predictor.predictor_pos_embed[0]}}
    src = train_state_from_jax(tree, consts, enc_cfg, pred_cfg, device="cpu")
    ckpt = {"encoder": src.encoder.state_dict(), "predictor": src.predictor.state_dict(),
            "target_encoder": src.target.state_dict(),
            "opt": {"step": src.step, "mu": src.mu, "nu": src.nu}}
    return ckpt, int(tree["epoch"])


def load_checkpoint(folder: str, tag: str, state, read_path: Optional[str] = None,
                    layout: Optional[Layout] = None) -> Tuple[object, int]:
    """Restore params, target, moments and step into ``state`` in place;
    returns (state, start epoch). ``read_path`` may be a ``.pth.tar`` or a
    JAX orbax run directory. A missing or unreadable checkpoint leaves the
    state as it is and returns epoch 0, as the reference does. Under a
    ``layout`` with fsdp > 1 the moments keep this rank's slices."""
    path = read_path or checkpoint_path(folder, tag)
    if not os.path.exists(path):
        logger.info("no checkpoint at %s; starting fresh", path)
        return state, 0
    if orbax.is_checkpoint(path):
        try:
            ckpt, epoch = _read_orbax(path, state)
        except (OSError, ValueError, KeyError, NotImplementedError) as e:
            logger.warning("failed to load checkpoint %s: %s", path, e)
            return state, 0
        ckpt["epoch"] = epoch
    else:
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        except (OSError, RuntimeError, pickle.UnpicklingError) as e:
            logger.warning("failed to load checkpoint %s: %s", path, e)
            return state, 0
    state.encoder.load_state_dict(ckpt["encoder"])
    state.predictor.load_state_dict(ckpt["predictor"])
    state.target.load_state_dict(ckpt["target_encoder"])
    plan = None
    if layout is not None and layout.fsdp > 1:
        plan = zero1_plan(state.named_params(), layout.fsdp, layout.min_size_to_shard)
    _restore_moments(path, ckpt["opt"], state, plan, layout)
    state.step = int(ckpt["opt"]["step"])
    epoch = int(ckpt["epoch"])
    logger.info("restored checkpoint from %s (epoch %d)", path, epoch)
    return state, epoch


def save_probe_checkpoint(folder: str, tag: str, probe, epoch: int) -> None:
    """Write ``<tag>-latest.pth.tar`` from an eval probe (an object with
    ``classifier``, ``mu``, ``nu`` and ``step``); in a data-parallel run
    every rank calls it, rank 0 writes, and a barrier follows."""
    if pdist.is_main():
        obj = {
            "classifier": probe.classifier.state_dict(),
            "opt": {"step": int(probe.step), "mu": probe.mu, "nu": probe.nu},
            "epoch": int(epoch),
        }
        _save_atomic(obj, checkpoint_path(folder, tag))
        logger.info("saved probe checkpoint at epoch %d", epoch)
    pdist.barrier()


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
