"""The port's frozen-eval pieces vs the JAX package on the CPU: the eval
transforms (multiview crops with and without the letterbox valid_hw, the
short-side resize + centre crop), the clip and frame aggregation, and one
probe train step and one val step of the video and the image probes, the
JAX side assembled from the JAX package's own functions as
jepa_tpu/evals/video_classification_frozen.py:262-296 and
image_classification_frozen.py:169-194 assemble them.

A tiny ViT (2 layers, width 128, 2 heads of 64, 32 px, 4 frames) is drawn
by the JAX package and carried across with encoder_state_from_jax /
classifier_state_from_jax; clips come from numpy with a seed. fp32
throughout; tolerances: aggregation 2e-4 (the model-forward tolerance),
loss rtol 2e-4 and updated probe parameters 5e-5 (one full update). JAX
runs first in each test, torch after.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.data import transforms as jax_tf
from jepa_tpu.evals import aggregation as jax_agg
from jepa_tpu.models.attentive import AttentiveCfg as JaxAttentiveCfg
from jepa_tpu.models.attentive import classifier_forward as jax_classifier_forward
from jepa_tpu.models.attentive import init_attentive_classifier as jax_init_classifier
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.models.vit import init_vit as jax_init_vit
from jepa_tpu.models.vit import vit_forward as jax_vit_forward
from jepa_tpu.train import optimizer as jax_opt
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu_torch.data import transforms
from jepa_tpu_torch.evals import aggregation
from jepa_tpu_torch.evals import image_classification_frozen as icf
from jepa_tpu_torch.evals import video_classification_frozen as vcf
from jepa_tpu_torch.models.attentive import AttentiveCfg, AttentiveClassifier
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import classifier_state_from_jax, encoder_state_from_jax

_TINY = dict(img_size=32, patch_size=16, tubelet_size=2, embed_dim=128, depth=2, num_heads=2,
             uniform_power=True, compute_dtype=jnp.float32)
AGG_TOL = 2e-4
LOSS_RTOL = 2e-4
PARAM_TOL = 5e-5
NUM_CLASSES = 5
SCHED = dict(warmup_steps=1, start_lr=1e-3, ref_lr=5e-3, final_lr=1e-4, t_max=6)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _encoder(num_frames, seed=0):
    """(JAX cfg, params, consts) and the port's frozen encoder + run cfg."""
    jcfg = JaxViTCfg(**_TINY, num_frames=num_frames)
    params, consts = jax_init_vit(jax.random.PRNGKey(seed), jcfg)
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ViTCfg)}
    cfg = ViTCfg(**{**kw, "compute_dtype": torch.float32, "fused_mlp": True})
    model = VisionTransformer(cfg)
    model.load_state_dict(encoder_state_from_jax(_numpy(params), _numpy(consts), cfg))
    return jcfg, params, consts, model.requires_grad_(False), cfg


def _clips(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# eval transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("letterbox", [False, True])
def test_multiview_crops_match_jax(letterbox):
    rng = np.random.default_rng(int(letterbox))
    if letterbox:  # samples letterboxed on a 64 x 64 canvas, short side 32
        clips = rng.integers(0, 256, (2, 2, 3, 64, 64, 3), dtype=np.uint8)
        vhw = np.array([[32, 57], [45, 32]], np.int32)
    else:
        clips = rng.integers(0, 256, (2, 2, 3, 32, 50, 3), dtype=np.uint8)
        vhw = None
    want = np.asarray(jax_tf.multiview_crops(
        jnp.asarray(clips), 32, 3, valid_hw=None if vhw is None else jnp.asarray(vhw)))
    got = transforms.multiview_crops(torch.from_numpy(clips), 32, 3,
                                     valid_hw=None if vhw is None else torch.from_numpy(vhw))
    assert got.shape == (2, 2, 3, 3, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(40, 56), (24, 30)])  # shrink (antialiased) and grow
def test_eval_transform_matches_jax(hw):
    clips = np.random.default_rng(hw[0]).integers(0, 256, (2, 3, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_tf.eval_transform(jnp.asarray(clips), crop_size=32))
    got = transforms.eval_transform(torch.from_numpy(clips), crop_size=32)
    assert got.shape == (2, 3, 32, 32, 3)
    # normalized units (1/(255*std) ~ 1/57 per 0..255 level); measured <= 4e-6
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attend", [True, False])
@pytest.mark.parametrize("pos_embed", [False, True])
def test_clip_aggregation_matches_jax(attend, pos_embed):
    jcfg, params, consts, model, cfg = _encoder(num_frames=4)
    clips = _clips((2, 2, 2, 4, 32, 32, 3), 1)  # [B, S, V, T, H, W, C]
    ci = np.array([[[0, 1, 2, 3], [10, 11, 12, 13]], [[4, 5, 6, 7], [2, 4, 6, 8]]], np.int32)
    jtable = jax_agg.temporal_pos_embed_table(128, tubelet_size=2) if pos_embed else None
    want = jax_agg.clip_aggregation(params, consts, jnp.asarray(clips), jcfg,
                                    attend_across_segments=attend, pos_embed_table=jtable,
                                    clip_indices=jnp.asarray(ci) if pos_embed else None)
    table = aggregation.temporal_pos_embed_table(128, tubelet_size=2) if pos_embed else None
    with torch.no_grad():
        got = aggregation.clip_aggregation(model, torch.from_numpy(clips), cfg,
                                           attend_across_segments=attend, pos_embed_table=table,
                                           clip_indices=torch.from_numpy(ci) if pos_embed else None)
    if pos_embed:
        np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    flat = lambda xs: [x for v in xs for x in (v if isinstance(v, list) else [v])]
    assert len(flat(got)) == len(flat(want)) == (2 if attend else 4)
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=AGG_TOL, rtol=0)


def test_frame_aggregation_matches_jax():
    jcfg, params, consts, model, cfg = _encoder(num_frames=1)
    clips = _clips((2, 1, 2, 3, 32, 32, 3), 2)
    ci = np.array([[[9, 15, 3]], [[0, 1, 2]]], np.int32)
    jtable = jax_agg.temporal_pos_embed_table(128, max_frames=16, tubelet_size=1)
    want = jax_agg.frame_aggregation(params, consts, jnp.asarray(clips), jcfg,
                                     pos_embed_table=jtable, clip_indices=jnp.asarray(ci))
    table = aggregation.temporal_pos_embed_table(128, max_frames=16, tubelet_size=1)
    with torch.no_grad():
        got = aggregation.frame_aggregation(model, torch.from_numpy(clips), cfg,
                                            pos_embed_table=table,
                                            clip_indices=torch.from_numpy(ci))
    assert len(got) == 2 and got[0].shape == (2, 3 * 4, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=AGG_TOL, rtol=0)


# ---------------------------------------------------------------------------
# probe train and val steps
# ---------------------------------------------------------------------------


def _probes(model, cfg, seed=3):
    """The JAX classifier (params, opt state, decay mask, cfg) and the
    port's Probe holding the same weights."""
    jacfg = JaxAttentiveCfg(embed_dim=128, num_heads=2, depth=1, num_classes=NUM_CLASSES,
                            compute_dtype=jnp.float32)
    clf = jax_init_classifier(jax.random.PRNGKey(seed), jacfg)
    acfg = AttentiveCfg(embed_dim=128, num_heads=2, depth=1, num_classes=NUM_CLASSES,
                        compute_dtype=torch.float32)
    port = AttentiveClassifier(acfg)
    port.load_state_dict(classifier_state_from_jax(_numpy(clf), acfg))
    probe = vcf.Probe(encoder=model, enc_cfg=cfg, classifier=port, acfg=acfg,
                      lr_sched=schedulers.WarmupCosine(**SCHED),
                      wd_sched=schedulers.CosineWD(ref_wd=0.01, final_wd=1e-6, t_max=6))
    return (clf, jax_opt.init_adamw_state(clf), jax_opt.decay_mask(clf), jacfg), probe


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_update_jit(clf, opt, mask, jacfg, feats, labels, sched_step):
    lr_sched = jax_sched.WarmupCosine(**SCHED)
    wd_sched = jax_sched.CosineWD(ref_wd=0.01, final_wd=1e-6, t_max=6)
    feats = [jax.lax.stop_gradient(f) for f in feats]

    def loss_fn(c):
        logits = [jax_classifier_forward(c, o, jacfg) for o in feats]
        onehot = jax.nn.one_hot(labels, NUM_CLASSES)
        return sum(-jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(lg), axis=-1))
                   for lg in logits) / len(logits)

    loss, grads = jax.value_and_grad(loss_fn)(clf)
    grads, _ = jax_opt.clip_by_global_norm(grads, 1.0, jnp.asarray(True))
    clf, opt, _ = jax_opt.adamw_update(clf, grads, opt, lr=lr_sched(sched_step),
                                       wd=wd_sched(sched_step), mask=mask, step=sched_step)
    return clf, opt, loss


def _jax_update(clf, opt, mask, jacfg, feats, labels, step):
    """The JAX eval's probe update (video_classification_frozen.py:262-285),
    jitted as the JAX eval jits it."""
    clf, opt, loss = _jax_update_jit(clf, opt, mask, jacfg, list(feats), labels,
                                     jnp.float32(step + 1))
    return clf, opt, float(loss)


def _jax_correct(clf, jacfg, feats, labels, weights):
    """The JAX eval's val step reduction (video_classification_frozen.py:287-296)."""
    logits = [jax_classifier_forward(clf, o, jacfg) for o in feats]
    probs = sum(jax.nn.softmax(lg) for lg in logits) / len(logits)
    hit = (jnp.argmax(probs, -1) == labels).astype(jnp.float32)
    return float(jnp.sum(hit * weights)), float(jnp.sum(weights))


def _assert_same_classifier(jax_clf, probe):
    want = classifier_state_from_jax(_numpy(jax_clf), probe.acfg)
    got = probe.classifier.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=PARAM_TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("attend", [True, False])
def test_video_probe_train_steps_match_jax(attend):
    """Two updates from the same weights on the same post-augmentation clips
    [B=3, S=2, V=1, ...]: losses, the updated probe and its moments."""
    jcfg, params, consts, model, cfg = _encoder(num_frames=4)
    (clf, opt, mask, jacfg), probe = _probes(model, cfg)
    labels = np.array([0, 3, 4])
    for step in range(2):
        clips = _clips((3, 2, 1, 4, 32, 32, 3), 10 + step)
        feats = jax_agg.clip_aggregation(params, consts, jnp.asarray(clips), jcfg,
                                         attend_across_segments=attend)
        if not attend:
            feats = [o for views in feats for o in views]
        clf, opt, loss = _jax_update(clf, opt, mask, jacfg, feats, jnp.asarray(labels), step)
        metrics = vcf.train_step(probe, torch.from_numpy(clips), torch.from_numpy(labels),
                                 attend_across_segments=attend)
        assert probe.step == step + 1
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_RTOL)
        _assert_same_classifier(clf, probe)
    mu = classifier_state_from_jax(_numpy(opt["mu"]), probe.acfg)
    for name, t in probe.mu.items():
        np.testing.assert_allclose(t.numpy(), mu[name].numpy(), atol=PARAM_TOL, rtol=0)


def test_video_probe_val_step_with_padded_batch_matches_jax():
    """(correct, total) over [B=4, S=2, V=2] multi-view clips whose last
    sample is a zero-weight repeat of the one before (the padded last
    batch), after one update so the probe is not at its init."""
    jcfg, params, consts, model, cfg = _encoder(num_frames=4)
    (clf, opt, mask, jacfg), probe = _probes(model, cfg, seed=4)
    labels = np.array([1, 2, 0, 0])
    clips = _clips((4, 2, 2, 4, 32, 32, 3), 20)
    clips[3] = clips[2]
    weights = np.array([1, 1, 1, 0], np.float32)
    feats = jax_agg.clip_aggregation(params, consts, jnp.asarray(clips), jcfg,
                                     attend_across_segments=True)
    clf, _, _ = _jax_update(clf, opt, mask, jacfg, feats, jnp.asarray(labels), 0)
    want = _jax_correct(clf, jacfg, feats, jnp.asarray(labels), jnp.asarray(weights))
    probe_feats = vcf.encode_views(probe, torch.from_numpy(clips), True)
    vcf.probe_update(probe, probe_feats, torch.from_numpy(labels))
    c, t = vcf.val_step(probe, torch.from_numpy(clips), torch.from_numpy(labels),
                        torch.from_numpy(weights), attend_across_segments=True)
    assert (float(c), float(t)) == want and want[1] == 3.0


def test_image_probe_train_and_val_steps_match_jax():
    """The image probe: each image repeated over the video encoder's 4
    frames, single-view CE; one update, then (correct, total)."""
    jcfg, params, consts, model, cfg = _encoder(num_frames=4)
    (clf, opt, mask, jacfg), probe = _probes(model, cfg, seed=5)
    images = _clips((3, 32, 32, 3), 30)
    labels = np.array([4, 1, 1])
    tiled = jnp.broadcast_to(jnp.asarray(images)[:, None], (3, 4, 32, 32, 3))
    feats = [jax_vit_forward(params, consts, tiled, jcfg)]
    clf, _, loss = _jax_update(clf, opt, mask, jacfg, feats, jnp.asarray(labels), 0)
    want = _jax_correct(clf, jacfg, feats, jnp.asarray(labels), jnp.ones(3))
    metrics = icf.train_step(probe, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_RTOL)
    _assert_same_classifier(clf, probe)
    c, t = icf.val_step(probe, torch.from_numpy(images), torch.from_numpy(labels),
                        torch.ones(3))
    assert (float(c), float(t)) == want
