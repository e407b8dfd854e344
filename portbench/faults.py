"""Faults planted in the program underneath a run, for the checks that the
comparison catches them (portbench/control.py on the card, the tests on the
CPU). Each is a context manager that patches the port while it is open."""

from __future__ import annotations

import contextlib
import importlib
from unittest import mock

import torch


def _step_module():
    return importlib.import_module("jepa_tpu_torch.train.step")


@contextlib.contextmanager
def unchanged_state():
    """Every update leaves the parameters, the target and the moments as
    they were."""
    stats = lambda *a, **k: {"exp_avg_abs_mean": torch.zeros(()),
                             "exp_avg_sq_mean": torch.zeros(())}
    step = _step_module()
    with mock.patch.object(step, "adamw_update_", stats), \
            mock.patch.object(step, "ema_update_", lambda *a, **k: None):
        yield


@contextlib.contextmanager
def half_batch_update():
    """Each update runs on the first half of its batch's rows (clips and
    masks): the mean is taken over the rest."""
    step = _step_module()
    build = step.build_train_step

    def half_build(*args, mask_sampler=None, **kwargs):
        def sampler(i, b, dev):
            me, mp = mask_sampler(i, b, dev)
            return [m[:b] for m in me], [m[:b] for m in mp]

        fn = build(*args, mask_sampler=sampler, **kwargs)

        def step_fn(state, batch):
            clips = batch["clips"]
            return fn(state, {**batch, "clips": clips[:clips.shape[0] // 2]})

        return step_fn

    with mock.patch.object(step, "build_train_step", half_build):
        yield


@contextlib.contextmanager
def clip_always():
    """Every gradient scaled to the clip norm, large or small (the min with
    1 left out)."""
    step = _step_module()
    norm_of = step.global_norm

    def clip(grads, max_norm, enabled):
        norm = norm_of(grads)
        if enabled:
            torch._foreach_mul_(grads, max_norm / (norm + 1e-6))
        return norm

    with mock.patch.object(step, "clip_by_global_norm", clip):
        yield


@contextlib.contextmanager
def altered_answer():
    """Each request's first clip gets its top class's probability swapped
    with the lowest one's."""
    api = importlib.import_module("jepa_tpu_torch.api")
    classify = api.VideoClassifier.classify

    def altered(self, clips, normalize=None):
        probs = classify(self, clips, normalize).clone()
        hi, lo = int(probs[0].argmax()), int(probs[0].argmin())
        probs[0, hi], probs[0, lo] = probs[0, lo].clone(), probs[0, hi].clone()
        return probs

    with mock.patch.object(api.VideoClassifier, "classify", altered):
        yield


@contextlib.contextmanager
def half_batch_request():
    """Each request computes the first half of its clips; the other half get
    the mean of those answers."""
    api = importlib.import_module("jepa_tpu_torch.api")
    classify = api.VideoClassifier.classify

    def half(self, clips, normalize=None):
        n = clips.shape[0]
        probs = classify(self, clips[:max(1, n // 2)], normalize)
        rest = probs.mean(0, keepdim=True).expand(n - probs.shape[0], -1)
        return torch.cat([probs, rest])

    with mock.patch.object(api.VideoClassifier, "classify", half):
        yield


FAULTS = {"pretrain": {"unchanged_state": unchanged_state, "half_batch": half_batch_update,
                        "clip_always": clip_always},
          "serve_video": {"altered_answer": altered_answer, "half_batch": half_batch_request}}
