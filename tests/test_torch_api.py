"""Port serving API (jepa_tpu_torch.api) vs jepa_tpu.api on the CPU.

Checkpoints are .pth.tar files written by the JAX package's
save_torch_checkpoint and by torch.save of the oracle probe; both packages
load them and answer the same clips. JAX runs first in each test, torch
after.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu import api as jax_api
from jepa_tpu.models.factory import vit_cfg as jax_vit_cfg
from jepa_tpu.models.vit import init_vit as jax_init_vit
from jepa_tpu.utils.checkpoint_port import save_torch_checkpoint
from jepa_tpu_torch import api
from tests.torch_oracle import OracleAttentiveClassifier, randomize

_GEO = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, uniform_power=True)


def _zoo_encoder(tmp_path, key="target_encoder", seed=5):
    cfg = jax_vit_cfg("vit_tiny", **_GEO, compute_dtype=jnp.float32)
    params, consts = jax_init_vit(jax.random.PRNGKey(seed), cfg)
    path = str(tmp_path / "zoo.pth.tar")
    save_torch_checkpoint(path, **{key: (params, consts)}, epoch=1, cfg=cfg)
    return path


def _uint8_clips(seed, b=2):
    return np.random.default_rng(seed).integers(0, 256, size=(b, 4, 32, 32, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("key", ["target_encoder", "encoder"])
def test_encode_matches_jax(tmp_path, key):
    path = _zoo_encoder(tmp_path, key)
    jenc = jax_api.load_encoder(path, "vit_tiny", **_GEO, compute_dtype=jnp.float32)
    clips = _uint8_clips(0)
    xf = np.random.default_rng(1).normal(size=(1, 4, 32, 32, 3)).astype(np.float32)
    want_u8 = np.asarray(jenc.encode(clips))
    want_f = np.asarray(jenc.encode(xf))

    enc = api.load_encoder(path, "vit_tiny", **_GEO, compute_dtype=torch.float32,
                           device="cpu")
    got_u8 = enc.encode(clips)
    got_f = enc.encode(xf)
    assert got_u8.dtype == torch.float32 and got_u8.shape == (2, 8, 192)
    np.testing.assert_allclose(got_u8.numpy(), want_u8, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=2e-4, rtol=0)


def test_classify_matches_jax(tmp_path):
    enc_path = _zoo_encoder(tmp_path)
    oracle = randomize(OracleAttentiveClassifier(dim=192, heads=3, num_classes=5), seed=2)
    probe_path = str(tmp_path / "probe.pth.tar")
    torch.save({"classifier": oracle.state_dict()}, probe_path)
    clips = _uint8_clips(2)
    jenc = jax_api.load_encoder(enc_path, "vit_tiny", **_GEO, compute_dtype=jnp.float32)
    want = np.asarray(jax_api.load_classifier(probe_path, jenc, num_classes=5).classify(clips))

    enc = api.load_encoder(enc_path, "vit_tiny", **_GEO, compute_dtype=torch.float32,
                           device="cpu")
    clf = api.load_classifier(probe_path, enc, num_classes=5)
    got = clf.classify(clips)
    assert got.shape == (2, 5) and clf.num_classes == 5
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    # the oracle's own forward on the port's features
    with torch.no_grad():
        oracle_probs = torch.softmax(oracle(enc.encode(clips)), dim=-1)
    np.testing.assert_allclose(got.numpy(), oracle_probs.numpy(), atol=2e-5, rtol=0)


def test_bf16_encode_close_to_jax(tmp_path):
    path = _zoo_encoder(tmp_path)
    clips = _uint8_clips(3)
    want = np.asarray(jax_api.load_encoder(path, "vit_tiny", **_GEO).encode(clips))
    enc = api.load_encoder(path, "vit_tiny", **_GEO, device="cpu")
    got = enc.encode(clips)
    assert enc.model.blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(got, torch.from_numpy(want), dim=-1)
    assert cos.min().item() > 0.999, cos.min().item()


def test_strict_and_tolerant_loading(tmp_path):
    path = _zoo_encoder(tmp_path)
    with pytest.raises(ValueError, match="checkpoint_key"):
        api.load_encoder(path, "vit_tiny", **_GEO, checkpoint_key="target", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        api.load_encoder(path, "vit_small", **_GEO, device="cpu")
    enc = api.load_encoder(path, "vit_small", **_GEO, tolerant=True, device="cpu")
    assert enc.embed_dim == 384
    # a zoo file at another resolution: pos_embed alone is regenerated
    enc = api.load_encoder(path, "vit_tiny", **{**_GEO, "img_size": 64}, device="cpu")
    assert enc.model.pos_embed.shape == (1, 2 * 4 * 4, 192)
    # a path that is neither a .pth.tar nor an orbax directory (one with _METADATA)
    with pytest.raises(ValueError, match="nor an orbax checkpoint directory"):
        api.load_encoder(str(tmp_path / "run-latest"), "vit_tiny", **_GEO, device="cpu")


def test_classifier_geometry_mismatch_raises(tmp_path):
    enc = api.load_encoder(_zoo_encoder(tmp_path), "vit_tiny", **_GEO, device="cpu")
    probe_path = str(tmp_path / "probe.pth.tar")
    torch.save({"classifier": OracleAttentiveClassifier(dim=192, heads=3,
                                                        num_classes=5).state_dict()},
               probe_path)
    with pytest.raises(ValueError):
        api.load_classifier(probe_path, enc, num_classes=9)


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_encoder(_zoo_encoder(tmp_path), "vit_tiny", **_GEO)
