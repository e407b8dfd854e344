"""Activation checkpointing that keeps named tensors: the port's remat='attn'
(counterpart of jepa_tpu/models/transformer.py::_save_flash_residuals, the
selective policy of ``jax.checkpoint``).

``checkpoint_keeping(fn, x)`` runs ``fn(x)`` under
``torch.utils.checkpoint`` (non-reentrant), so the backward recomputes fn
to get back what its autograd nodes saved; but every ``keep(compute,
packs)`` that fn reaches keeps its result from the forward, and the
recomputation reads the result back instead of computing it. That covers
what the JAX policy saves and the selective policy of
``torch.utils.checkpoint`` cannot see: a kernel launched through ctypes
inside an ``autograd.Function`` is no aten op. The callers:

  * the flash attention Functions keep their forward's (o, lse), so the
    backward launches no second forward kernel (the JAX package's
    ``optimize_remat`` custom_vjps);
  * ``transformer.linear_f32(..., keep=True)`` keeps the qkv projection of
    the token-major flash route and the fc1 pre-activation (the JAX
    package's ``qkv_out`` and ``fc1_out`` names, saved by default);
  * ``fused_mlp.LinearGelu`` (``fused_mlp='force'``) keeps H8's (o, z),
    z being that fc1 pre-activation.

The recomputation must hand checkpoint the same saved tensors, in the same
order, as the forward's autograd nodes saved (checkpoint matches them by
position and checks their shapes and dtypes). A Function keeps its
outputs inside its own forward, which saves as before; a kept linear
replays through ``_Packs``, which saves what ``MatmulF32.saved`` names
and returns the kept output. Its backward never runs: the backward walks
the forward's graph and only reads the recomputed tensors.

Outside ``checkpoint_keeping`` (no remat, full remat, grad-free forwards)
``keep`` just computes.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

_local = threading.local()


class _Scope:
    """The kept tensors of one checkpointed call, and whether the code
    inside records them (the forward) or reads them back (the
    recomputation); entered around each, possibly on the autograd
    engine's thread."""

    def __init__(self, kept: collections.deque, replay: bool):
        self.kept, self.replay = kept, replay

    def __enter__(self):
        self.prev = getattr(_local, "scope", None)
        _local.scope = self

    def __exit__(self, *exc):
        _local.scope = self.prev


class _Packs(torch.autograd.Function):
    """Returns ``out`` and saves ``packs``: the recomputation's stand-in
    for an op whose kept output it reads back."""

    @staticmethod
    def forward(ctx, out, *packs):
        ctx.save_for_backward(*packs)
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a recomputation's stand-in is never differentiated")


def _detach(out):
    return out.detach() if torch.is_tensor(out) else tuple(t.detach() for t in out)


def keep(compute: Callable, packs=()):
    """``compute()`` (a tensor or a tuple of tensors), kept across the
    recomputation of an enclosing ``checkpoint_keeping``. ``packs`` are the
    tensors the autograd nodes inside ``compute`` save, in order; empty
    when ``compute`` runs inside an ``autograd.Function``'s forward."""
    scope = getattr(_local, "scope", None)
    if scope is None:
        return compute()
    if scope.replay:
        out = scope.kept.popleft()
        return _Packs.apply(out, *packs) if packs else out
    out = compute()
    scope.kept.append(_detach(out))
    return out


def checkpoint_keeping(fn: Callable, *args):
    """fn(*args) with its activations recomputed in the backward, except
    the results of the ``keep`` calls inside it."""
    kept = collections.deque()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (_Scope(kept, False), _Scope(kept, True)))
