"""The port's orbax reader and writer (jepa_tpu_torch/utils/{zstd,ocdbt,
orbax}.py) against the JAX package's orbax checkpoints on the CPU.

The OCDBT store lists exactly the keys and values tensorstore's ocdbt
KvStore lists (a JAX-written checkpoint's root and per-process stores, a
port-written store, and a tensorstore store with interior nodes and
version-tree nodes); a checkpoint saved by
jepa_tpu.utils.checkpoint.save_checkpoint (fp32, bf16, int32 / int64 /
bool arrays, an int32 scalar epoch and a leaf sharded over the 8 virtual
devices) reads bit-equal; a port-written one reads bit-equal through
jepa_tpu's load_subtree and load_checkpoint; the strict errors are JAX's
word for word; each ``*_to_jax`` inverts its ``*_from_jax`` bit-equal and
the shape templates are the JAX init trees' shapes.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jepa_tpu.models.attentive import AttentiveCfg as JaxAttentiveCfg
from jepa_tpu.models.attentive import init_attentive_classifier as jax_init_classifier
from jepa_tpu.models.factory import predictor_cfg_for as jax_pred_cfg
from jepa_tpu.models.factory import vit_cfg as jax_vit_cfg
from jepa_tpu.train.step import init_train_state as jax_init_train_state
from jepa_tpu.utils import checkpoint as jax_ckpt
from jepa_tpu_torch.models.attentive import AttentiveCfg
from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
from jepa_tpu_torch.utils import checkpoint_port as cp
from jepa_tpu_torch.utils import ocdbt, orbax, zstd

GEO = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, uniform_power=True)


def _raw(x) -> np.ndarray:
    """A leaf's bytes as numpy (bf16 as uint16), from either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_bit_equal(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, set(got), set(want))
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{where}/{k}")
        return
    g, w = _raw(got), _raw(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype, w.dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes(), where


@pytest.fixture(scope="module")
def jax_tree():
    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()), ("d",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((64, 40)), jnp.float32),
                             NamedSharding(mesh, P("d", None)))
    return {
        "target": {"w": rng.standard_normal((30, 40)).astype(np.float32),
                   "b": jnp.asarray(rng.standard_normal(700), jnp.bfloat16),
                   "nested": {"i": np.arange(600, dtype=np.int32).reshape(20, 30)}},
        "sh": sharded, "step": jnp.asarray(7, jnp.int32),
        "i8": np.arange(5, dtype=np.int64) - 2, "mask": np.array([True, False, True]),
        "small": np.float32([1.5, -2.0]),
    }


@pytest.fixture(scope="module")
def jax_ckpt_dir(tmp_path_factory, jax_tree):
    folder = tmp_path_factory.mktemp("jax_orbax")
    jax_ckpt.save_checkpoint(str(folder), "run", jax_tree, epoch=3)
    return str(folder / "run-latest")


def _tensorstore_items(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(root)}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _port_items(root):
    store = ocdbt.Store(root)
    return {k: store.read(k).tobytes() for k in store.keys()}


def _tensorstore_deep_store(root):
    """Interior nodes (a 300-byte node limit), values inline and out of
    line, and 20 generations at arity 2 (version-tree nodes)."""
    cfg = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
           "version_tree_arity_log2": 1}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/", "config": cfg}).result()
    for g in range(20):
        with ts.Transaction() as txn:
            for i in range(g * 4, g * 4 + 4):
                kv.with_transaction(txn)[f"leaf{i:03d}/part.{i % 7}"] = b"v%d" % i * (1 + i % 11)
    return root


@pytest.mark.parametrize("which", ["jax-root", "jax-process", "port", "tensorstore-deep"])
def test_ocdbt_store_lists_what_tensorstore_lists(tmp_path, jax_ckpt_dir, which):
    if which == "jax-root":
        root = jax_ckpt_dir
    elif which == "jax-process":
        root = os.path.join(jax_ckpt_dir, "ocdbt.process_0")
    elif which == "tensorstore-deep":
        root = _tensorstore_deep_store(str(tmp_path / "deep"))
    else:
        root = str(tmp_path / "port")
        rng = np.random.default_rng(1)
        with ocdbt.StoreWriter(root) as w:
            w.put(b"a/.zarray", b'{"x": 1}')
            w.put(b"a/0.0", rng.standard_normal(600).astype(np.float32))
            w.put(b"empty", b"")
            w.put(b"ab", b"z" * 3000)
    want = _tensorstore_items(root)
    got = _port_items(root)
    assert len(want) >= 4 and list(got) == sorted(want) and got == want
    store = ocdbt.Store(root)
    assert store.config.manifest_kind == 0
    if which.startswith("jax") or which == "port":  # orbax's config, uuid aside
        assert store.config == dataclasses.replace(ocdbt.ORBAX_CONFIG, uuid=store.config.uuid)


def test_ocdbt_checks_every_blob(tmp_path, jax_ckpt_dir):
    root = str(tmp_path / "ck")
    shutil.copytree(jax_ckpt_dir, root)
    manifest = os.path.join(root, ocdbt.MANIFEST)
    data = bytearray(open(manifest, "rb").read())
    data[20] ^= 0x01
    open(manifest, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        ocdbt.Store(root)
    open(manifest, "wb").write(bytes(data[:-6]))
    with pytest.raises(ValueError, match="header says"):
        ocdbt.Store(root)
    with pytest.raises(ValueError, match="magic"):
        ocdbt._read_blob(b"\0" * 32, ocdbt.NODE_MAGIC, "x")


def test_zstd_binding(monkeypatch):
    assert zstd.version().count(".") == 2
    x = np.random.default_rng(2).standard_normal((33, 7)).astype(np.float32)
    frame = zstd.compress(x, 1)
    out = np.empty_like(x)
    zstd.decompress_into(memoryview(frame), out)
    assert out.tobytes() == x.tobytes() and zstd.decompress(frame).tobytes() == x.tobytes()
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress_into(frame, np.empty(x.size + 1, np.float32))
    monkeypatch.setattr(zstd, "_LIB", None)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd_absent.so.9")
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(OSError, match="libzstd_absent.so.9"):
        zstd.version()


def test_jax_writes_port_reads(jax_ckpt_dir, jax_tree):
    got = orbax.read_tree(jax_ckpt_dir)
    want = {**jax.device_get(jax_tree), "epoch": np.int32(3)}
    _assert_bit_equal(got, want)
    assert type(got["epoch"]) is np.int32 and got["target"]["b"].dtype == torch.bfloat16
    keys = ocdbt.Store(jax_ckpt_dir).keys()
    assert [k for k in keys if k.startswith(b"sh/") and not k.endswith(b".zarray")] == [
        f"sh/{i}.0".encode() for i in range(8)]  # one chunk a device
    _assert_bit_equal(orbax.read_tree(jax_ckpt_dir, "target"), want["target"])
    _assert_bit_equal(orbax.read_tree(jax_ckpt_dir, ("target", "nested", "i")),
                      want["target"]["nested"]["i"])


def test_port_writes_jax_reads(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"target": {"w": rng.standard_normal((30, 40)).astype(np.float32),
                       "b": torch.randn(700, generator=torch.Generator().manual_seed(0)).bfloat16(),
                       "nested": {"i": np.arange(6, dtype=np.int32).reshape(2, 3)}},
            "step": np.asarray(11, np.int32), "i8": np.arange(4, dtype=np.int64),
            "mask": np.array([False, True]), "epoch": np.int32(5)}
    path = str(tmp_path / "port-latest")
    orbax.save_tree(path, tree)
    sub = jax_ckpt.load_subtree(path, {"target": {"w": np.zeros((30, 40), np.float32),
                                                  "b": jnp.zeros(700, jnp.bfloat16)}})
    _assert_bit_equal(sub["target"], {k: tree["target"][k] for k in ("w", "b")})
    template = {"target": {"w": jnp.zeros((30, 40)), "b": jnp.zeros(700, jnp.bfloat16),
                           "nested": {"i": jnp.zeros((2, 3), jnp.int32)}},
                "step": jnp.zeros((), jnp.int32), "i8": np.zeros(4, np.int64),
                "mask": np.zeros(2, bool)}
    state, epoch = jax_ckpt.load_checkpoint(str(tmp_path), "port", template)
    assert epoch == 5
    _assert_bit_equal(jax.device_get(state), {k: v for k, v in tree.items() if k != "epoch"})
    _assert_bit_equal(orbax.read_tree(path), tree)  # and the port reads its own
    orbax.save_tree(path, {"x": np.ones(3, np.float32)})  # replaces, as force=True does
    assert set(orbax.read_tree(path)) == {"x"}
    with pytest.raises(FileExistsError):
        orbax.save_tree(str(tmp_path), tree)  # a directory that is not a checkpoint


@pytest.mark.parametrize("case", ["missing", "shape", "subtree"])
def test_load_subtree_is_strict_as_jax(jax_ckpt_dir, case):
    w = {"missing": (30, 40), "shape": (40, 30), "subtree": (30, 40)}[case]
    template = {"target": {"w": w, **({"nope": (3,)} if case == "missing" else {})}}
    if case == "subtree":  # a template leaf where the checkpoint holds a subtree
        template = {"target": {"nested": (2,)}}
    jax_template = jax.tree.map(lambda s: np.zeros(s, np.float32), template,
                                is_leaf=lambda x: isinstance(x, tuple))
    err = KeyError if case != "shape" else ValueError
    with pytest.raises(err) as port_err:
        orbax.load_subtree(jax_ckpt_dir, template)
    if case != "subtree":  # JAX fails here with an AttributeError of orbax's metadata
        with pytest.raises(err) as jax_err:
            jax_ckpt.load_subtree(jax_ckpt_dir, jax_template)
        assert str(port_err.value) == str(jax_err.value)
    got = orbax.load_subtree(jax_ckpt_dir, {"target": {"w": (30, 40)}, "epoch": ()})
    assert got["epoch"] == 3 and got["target"]["w"].shape == (30, 40)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        orbax.load_subtree(jax_ckpt_dir + "-absent", template)


def _rewrite(src, dst, zarray=None, metadata=None):
    """A copy of the port-written checkpoint ``src`` with its arrays'
    ``.zarray`` or its ``_METADATA`` entries overridden."""
    store = ocdbt.Store(src)
    with ocdbt.StoreWriter(dst) as w:
        for key in store.keys():
            val = store.read(key)
            if key.endswith(b".zarray") and zarray:
                val = json.dumps({**json.loads(val.tobytes()), **zarray}).encode()
            w.put(key, val)
    meta = json.load(open(os.path.join(src, orbax.METADATA)))
    json.dump({**meta, **(metadata or {})}, open(os.path.join(dst, orbax.METADATA), "w"))
    return dst


@pytest.mark.parametrize("change, words", [
    ({"metadata": {"use_zarr3": True}}, "zarr v3"),
    ({"metadata": {"use_ocdbt": False}}, "without OCDBT"),
    ({"zarray": {"compressor": {"id": "blosc", "cname": "lz4"}}}, "compressor 'blosc'"),
    ({"zarray": {"filters": [{"id": "delta"}]}}, "filters"),
    ({"zarray": {"order": "F"}}, "order 'F'"),
    ({"zarray": {"dtype": ">f4"}}, "dtype '>f4'"),
])
def test_refuses_other_formats(tmp_path, change, words):
    src = str(tmp_path / "src")
    orbax.save_tree(src, {"w": np.ones((2, 3), np.float32)})
    dst = _rewrite(src, str(tmp_path / "dst"), **change)
    with pytest.raises(NotImplementedError, match=words):
        orbax.read_tree(dst)


def test_chunk_grid_and_fill_value(tmp_path):
    """A 5 x 3 array in 2 x 2 chunks (edge chunks padded, one missing),
    uncompressed, read back as tensorstore's zarr driver reads it."""
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    root = str(tmp_path / "grid")
    zarray = {"chunks": [2, 2], "compressor": None, "dimension_separator": ".",
              "dtype": "<f4", "fill_value": -1.0, "filters": None, "order": "C",
              "shape": [5, 3], "zarr_format": 2}
    with ocdbt.StoreWriter(root) as w:
        w.put(b"x/.zarray", json.dumps(zarray).encode())
        for i in range(3):
            for j in range(2):
                if (i, j) == (1, 1):
                    continue
                chunk = np.zeros((2, 2), np.float32)
                part = x[2 * i:2 * i + 2, 2 * j:2 * j + 2]
                chunk[:part.shape[0], :part.shape[1]] = part
                w.put(f"x/{i}.{j}".encode(), chunk)
    json.dump({"tree_metadata": {"('x',)": {
        "key_metadata": [{"key": "x", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False}, open(os.path.join(root, orbax.METADATA), "w"))
    want = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                  "base": f"file://{root}/", "path": "x/"}}
                   ).result().read().result()
    got = orbax.read_tree(root)["x"]
    expect = x.copy()
    expect[2:4, 2:3] = -1.0
    assert got.tobytes() == np.asarray(want).tobytes() == expect.tobytes()


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


@pytest.fixture(scope="module")
def jax_state():
    enc_cfg = jax_vit_cfg("vit_tiny", **GEO, compute_dtype=jnp.float32)
    pred_cfg = jax_pred_cfg(enc_cfg, predictor_embed_dim=48, depth=2, num_mask_tokens=2)
    state, consts = jax_init_train_state(jax.random.PRNGKey(4), enc_cfg, pred_cfg)
    return _np_tree(state), _np_tree(consts)


@pytest.mark.parametrize("what", ["encoder", "predictor", "classifier", "classifier-depth2",
                                  "train_state"])
def test_to_jax_inverts_from_jax(jax_state, what):
    enc_cfg = vit_cfg("vit_tiny", **GEO, compute_dtype=torch.float32)
    pred_cfg = predictor_cfg_for(enc_cfg, predictor_embed_dim=48, depth=2, num_mask_tokens=2)
    state, consts = jax_state
    if what == "encoder":
        tree = state["params"]["encoder"]
        back = cp.encoder_state_to_jax(cp.encoder_state_from_jax(tree, consts["encoder"], enc_cfg))
        template = cp.encoder_template(enc_cfg)
    elif what == "predictor":
        tree = jax.tree.map(lambda a: a + 0.25, state["params"]["predictor"])  # nonzero tokens
        back = cp.predictor_state_to_jax(
            cp.predictor_state_from_jax(tree, consts["predictor"], pred_cfg))
        template = cp.predictor_template(pred_cfg)
    elif what.startswith("classifier"):
        depth = 2 if what.endswith("2") else 1
        tree = _np_tree(jax_init_classifier(
            jax.random.PRNGKey(5), JaxAttentiveCfg(embed_dim=192, num_heads=3, depth=depth,
                                                   num_classes=5)))
        acfg = AttentiveCfg(embed_dim=192, num_heads=3, depth=depth, num_classes=5)
        back = cp.classifier_state_to_jax(cp.classifier_state_from_jax(tree, acfg))
        template = cp.classifier_template(acfg)
    else:
        rng = np.random.default_rng(6)
        tree = {**state, "step": np.asarray(9, np.int32),
                "opt": jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                    state["opt"])}
        port = cp.train_state_from_jax(tree, consts, enc_cfg, pred_cfg, device="cpu")
        back = cp.train_state_to_jax(port)
        template = cp.train_state_template(enc_cfg, pred_cfg)
    _assert_bit_equal(back, tree)
    assert template == _shapes(tree)
