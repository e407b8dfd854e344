"""The port's zoo-checkpoint converter (jepa_tpu_torch/utils/port_cli.py)
against the JAX package's (jepa_tpu/utils/port_cli.py) on the CPU.

A seeded ``.pth.tar`` at vit_tiny's width (192 wide, 3 heads) and 2
blocks, over 4 frames of 32 px, goes through both ``convert`` functions.
Each output is read by jepa_tpu's ``load_subtree`` and by the port's
``orbax.read_tree``: every leaf under ``target`` and ``params/encoder``,
and ``epoch``, is bit-equal across the two outputs and the two readers.
The port's ``api.load_encoder`` of the directory encodes bit-equal to
the same call on the ``.pth.tar`` (fp32); ``main(argv)`` prints the path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.models import factory as jax_factory
from jepa_tpu.utils import checkpoint as jax_ckpt
from jepa_tpu.utils import port_cli as jax_port_cli
from jepa_tpu_torch import api
from jepa_tpu_torch.models import factory
from jepa_tpu_torch.models.vit import init_vit
from jepa_tpu_torch.utils import orbax, port_cli
from tests.test_torch_orbax import _assert_bit_equal

GEO = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, uniform_power=True)
ARGS = dict(model="vit_tiny", patch_size=16, num_frames=4, tubelet_size=2, img_size=32,
            uniform_power=True, checkpoint_key="target_encoder")
DEPTH = 2


@pytest.fixture
def two_blocks(monkeypatch):
    """vit_tiny cut to DEPTH blocks in both packages' factories."""
    for specs in (factory._SPECS, jax_factory._SPECS):
        dim, _, heads, ratio, patch = specs["vit_tiny"]
        monkeypatch.setitem(specs, "vit_tiny", (dim, DEPTH, heads, ratio, patch))


@pytest.fixture
def zoo_file(tmp_path, two_blocks):
    """A seeded zoo-style file: the target encoder under ``module.``
    prefixes (as a DDP run saves it) and a different context encoder."""
    cfg = factory.vit_cfg("vit_tiny", **GEO)
    target = init_vit(cfg, torch.Generator().manual_seed(0)).state_dict()
    context = init_vit(cfg, torch.Generator().manual_seed(1)).state_dict()
    path = tmp_path / "zoo.pth.tar"
    torch.save({"target_encoder": {f"module.{k}": v for k, v in target.items()},
                "encoder": context, "epoch": 7}, path)
    return str(path)


def _jax_read(path, like):
    """``path`` through jepa_tpu's strict load_subtree, with ``like``'s
    arrays as its template and ``epoch`` as load_checkpoint's np.int32
    (orbax restores a scalar as a Python int: returned apart)."""
    template = {k: v for k, v in like.items() if k != "epoch"}
    template = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), template)
    out = jax.device_get(jax_ckpt.load_subtree(path, dict(template, epoch=np.int32(0))))
    return out, out.pop("epoch")


def test_convert_matches_jax(tmp_path, zoo_file):
    jax_path = jax_port_cli.convert(zoo_file, str(tmp_path / "jax"), tag="zoo", **ARGS)
    port_path = port_cli.convert(zoo_file, str(tmp_path / "port"), tag="zoo", **ARGS)
    assert port_path == str(tmp_path / "port" / "zoo-latest")
    want = orbax.read_tree(jax_path)
    assert set(want) == {"target", "params", "epoch"} and set(want["params"]) == {"encoder"}
    assert want["target"]["blocks"]["attn"]["qkv_w"].shape == (DEPTH, 192, 576)
    for path in (jax_path, port_path):
        _assert_bit_equal(orbax.read_tree(path), want, path)
        arrays, epoch = _jax_read(path, want)
        _assert_bit_equal(arrays, {k: v for k, v in want.items() if k != "epoch"}, path)
        assert epoch == 0, (path, epoch)
    _assert_bit_equal(want["params"]["encoder"], want["target"])
    assert want["epoch"].dtype == np.int32 and int(want["epoch"]) == 0

    # the converted directory serves what the .pth.tar serves, bit for bit
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    kw = dict(**GEO, compute_dtype=torch.float32, device="cpu")
    from_zoo = api.load_encoder(zoo_file, "vit_tiny", **kw).encode(clips)
    for key in ("target_encoder", "encoder"):
        got = api.load_encoder(port_path, "vit_tiny", checkpoint_key=key, **kw).encode(clips)
        assert got.shape == (2, 8, 192) and torch.equal(got, from_zoo), key


def test_main_prints_the_path(tmp_path, zoo_file, capsys):
    dst = tmp_path / "cli"
    port_cli.main([zoo_file, str(dst), "--model", "vit_tiny", "--num-frames", "4",
                   "--img-size", "32", "--uniform-power", "--checkpoint-key", "encoder",
                   "--tag", "ctx"])
    path = capsys.readouterr().out.strip()
    assert path == str(dst / "ctx-latest")
    want = jax_port_cli.convert(zoo_file, str(tmp_path / "jax"), tag="ctx",
                                **dict(ARGS, checkpoint_key="encoder"))
    _assert_bit_equal(orbax.read_tree(path), orbax.read_tree(want))
