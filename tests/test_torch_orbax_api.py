"""The port's entry points on orbax checkpoints that the JAX package wrote,
on the CPU: ``api.load_encoder`` (both checkpoint keys) and
``api.load_classifier`` answer the same clips as jepa_tpu.api within 2e-4
in fp32; the video and image eval CLIs restore the encoder of an orbax
run directory bit-equal to the JAX evals' ``_load_encoder``; the app's
``load_checkpoint`` resumes a JAX train state bit-equal to
``train_state_from_jax`` of it, with its step and epoch.
"""

import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu import api as jax_api
from jepa_tpu.evals.video_classification_frozen import _load_encoder as jax_load_encoder
from jepa_tpu.models.attentive import AttentiveCfg as JaxAttentiveCfg
from jepa_tpu.models.attentive import init_attentive_classifier as jax_init_classifier
from jepa_tpu.models.factory import predictor_cfg_for as jax_pred_cfg
from jepa_tpu.models.factory import vit_cfg as jax_vit_cfg
from jepa_tpu.train.step import init_train_state as jax_init_train_state
from jepa_tpu.utils import checkpoint as jax_ckpt
from jepa_tpu_torch import api
from jepa_tpu_torch.evals import image_classification_frozen as icf
from jepa_tpu_torch.evals import video_classification_frozen as vcf
from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
from jepa_tpu_torch.train.step import init_train_state
from jepa_tpu_torch.utils import checkpoint as ckpt_lib
from jepa_tpu_torch.utils import checkpoint_port as cp
from tests.test_torch_eval_app import _opt, _pretrain, _run
from tests.test_torch_orbax import _assert_bit_equal

GEO = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, uniform_power=True)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX train state (vit_tiny at full width over 4 frames of 32 px,
    a 48-wide predictor), its target and moments moved off the init so
    every tree differs, step 17, saved by save_checkpoint at epoch 3."""
    enc_cfg = jax_vit_cfg("vit_tiny", **GEO, compute_dtype=jnp.float32)
    pred_cfg = jax_pred_cfg(enc_cfg, predictor_embed_dim=48, depth=1, num_mask_tokens=2)
    state, consts = jax_init_train_state(jax.random.PRNGKey(7), enc_cfg, pred_cfg)
    state, consts = jax.device_get(state), jax.device_get(consts)
    rng = np.random.default_rng(0)
    noise = lambda a, s: (a + s * rng.standard_normal(a.shape)).astype(np.float32)
    state["target"] = jax.tree.map(lambda a: noise(a, 0.01), state["target"])
    state["opt"] = jax.tree.map(lambda a: noise(a, 1e-3), state["opt"])
    state["step"] = np.asarray(17, np.int32)
    folder = tmp_path_factory.mktemp("jax_run")
    jax_ckpt.save_checkpoint(str(folder), "vjepa", state, epoch=3)
    return str(folder / "vjepa-latest"), state, consts


def _clips(seed, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 4, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("key", ["target_encoder", "encoder"])
def test_load_encoder_from_orbax_matches_jax(jax_run, key):
    path, state, _ = jax_run
    clips = _clips(0)
    want = np.asarray(jax_api.load_encoder(path, "vit_tiny", **GEO, checkpoint_key=key,
                                           compute_dtype=jnp.float32).encode(clips))
    enc = api.load_encoder(path, "vit_tiny", **GEO, checkpoint_key=key,
                           compute_dtype=torch.float32, device="cpu")
    got = enc.encode(clips)
    assert got.shape == (2, 8, 192)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    tree = state["target"] if key == "target_encoder" else state["params"]["encoder"]
    _assert_bit_equal(cp.encoder_state_to_jax(enc.model.state_dict()), tree)


def test_load_classifier_from_orbax_matches_jax(jax_run, tmp_path):
    path, _, _ = jax_run
    acfg = JaxAttentiveCfg(embed_dim=192, num_heads=3, depth=1, num_classes=5,
                           compute_dtype=jnp.float32)
    clf = jax.device_get(jax_init_classifier(jax.random.PRNGKey(3), acfg))
    rng = np.random.default_rng(1)
    clf = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                       clf)
    jax_ckpt.save_checkpoint(str(tmp_path), "probe", {"classifier": clf}, epoch=2)
    probe = str(tmp_path / "probe-latest")
    clips = _clips(2)
    jenc = jax_api.load_encoder(path, "vit_tiny", **GEO, compute_dtype=jnp.float32)
    want = np.asarray(jax_api.load_classifier(probe, jenc, num_classes=5).classify(clips))
    enc = api.load_encoder(path, "vit_tiny", **GEO, compute_dtype=torch.float32, device="cpu")
    port = api.load_classifier(probe, enc, num_classes=5)
    got = port.classify(clips)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    _assert_bit_equal(cp.classifier_state_to_jax(port.classifier.state_dict()), clf)
    with pytest.raises(ValueError, match="shape mismatch"):
        api.load_classifier(probe, enc, num_classes=7)


@pytest.mark.parametrize("which", ["video", "image"])
def test_eval_cli_restores_the_orbax_encoder(jax_run, tmp_path, monkeypatch, which):
    path, _, _ = jax_run
    restored = []

    def spy(*args, **kwargs):
        restored.append(load(*args, **kwargs))
        return restored[-1]

    load = vcf.load_frozen_encoder
    monkeypatch.setattr(vcf, "load_frozen_encoder", spy)
    monkeypatch.setattr(icf, "load_frozen_encoder", spy)
    if which == "video":
        for split, n in (("train", 2), ("val", 2)):
            (tmp_path / f"{split}.csv").write_text(
                "".join(f"synthetic://{split}{i} {i % 2}\n" for i in range(n)))
        cfg = {"eval_name": "video_classification_frozen", "tag": "k400-tiny",
               "pretrain": _pretrain(str(tmp_path), path),
               "data": {"dataset_train": str(tmp_path / "train.csv"),
                        "dataset_val": str(tmp_path / "val.csv"), "num_classes": 2,
                        "frames_per_clip": 4, "num_segments": 1, "num_views_per_segment": 1,
                        "decode_backend": "synthetic", "num_workers": 0},
               "optimization": _opt(False, resolution=32)}
    else:
        from PIL import Image

        rng = np.random.default_rng(1)
        for split in ("train", "val"):
            for cls in ("a", "b"):
                d = tmp_path / "imgs" / split / cls
                d.mkdir(parents=True)
                Image.fromarray(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8)).save(
                    d / "0.png")
        cfg = {"eval_name": "image_classification_frozen",
               "pretrain": _pretrain(str(tmp_path), path),
               "data": {"root_path": str(tmp_path), "image_folder": "imgs", "num_classes": 2,
                        "resolution": 32, "num_workers": 0},
               "optimization": _opt(False)}
    accs = _run(tmp_path, cfg)
    assert len(accs) == 1 and len(restored) == 1
    enc_cfg = jax_vit_cfg("vit_tiny", **GEO, compute_dtype=jnp.float32)
    want, _ = jax_load_encoder(path, enc_cfg, "target_encoder", logging.getLogger(__name__))
    _assert_bit_equal(cp.encoder_state_to_jax(restored[0].state_dict()), jax.device_get(want))


def test_app_load_checkpoint_resumes_a_jax_run(jax_run, tmp_path, caplog):
    path, state, consts = jax_run
    enc_cfg = vit_cfg("vit_tiny", **GEO, compute_dtype=torch.float32)
    pred_cfg = predictor_cfg_for(enc_cfg, predictor_embed_dim=48, depth=1, num_mask_tokens=2)
    fresh = lambda: init_train_state(enc_cfg, pred_cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    got, epoch = ckpt_lib.load_checkpoint(str(tmp_path), "vjepa", fresh(), read_path=path)
    want = cp.train_state_from_jax(state, consts, enc_cfg, pred_cfg, device="cpu")
    assert epoch == 3 and got.step == want.step == 17
    _assert_bit_equal(cp.train_state_to_jax(got), cp.train_state_to_jax(want))
    for name in ("encoder", "predictor", "target"):
        _assert_bit_equal({k: v.numpy() for k, v in getattr(got, name).state_dict().items()},
                          {k: v.numpy() for k, v in getattr(want, name).state_dict().items()})
    # an unreadable orbax directory: epoch 0 and a warning, as for a .pth.tar
    broken = str(tmp_path / "broken")
    shutil.copytree(path, broken)
    with open(os.path.join(broken, "manifest.ocdbt"), "r+b") as f:
        f.seek(30)
        f.write(b"\xff")
    before = fresh()
    caplog.set_level(logging.WARNING)
    kept, epoch = ckpt_lib.load_checkpoint(str(tmp_path), "vjepa", before, read_path=broken)
    assert epoch == 0 and kept.step == 0 and "failed to load checkpoint" in caplog.text
