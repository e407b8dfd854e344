"""Orbax checkpoints (what jepa_tpu/utils/checkpoint.py writes through
``orbax.checkpoint.PyTreeCheckpointer``) read and written without JAX.

A checkpoint is a directory: ``_METADATA`` (JSON; one entry per leaf, its
key path under ``key_metadata`` and its kind under ``value_type``), and an
OCDBT store (``utils/ocdbt.py``) holding one zarr v2 array per leaf under
the leaf's keys joined by '.': ``<name>/.zarray`` (JSON: shape, chunks,
dtype, compressor, fill value) and one value per chunk, ``<name>/i.j.k``
(``<name>/0`` for a 0-d array). A chunk is the C-order bytes of the full
chunk shape, zstd-coded (its frame states no size: the size comes from
``.zarray``). An unsharded leaf is one chunk; one sharded over 8 devices
is 8.

Read: dtypes ``<f4``, ``<f2``, ``<i4``, ``<i8``, ``|b1`` and ``bfloat16``
(returned as a torch.bfloat16 tensor; numpy has no bfloat16), C order,
compressor zstd or none; a missing chunk reads as the fill value. Filters,
other compressors, zarr v3, checkpoints without OCDBT and trees of other
containers than dicts raise ``NotImplementedError`` naming the format. ``value_type: scalar`` leaves
come back as numpy scalars, every other leaf as an array.

Write (``save_tree``): one chunk per leaf, zstd level 1, and the
``_METADATA`` / ``_CHECKPOINT_METADATA`` that orbax's ``PyTreeCheckpointer``
restores from.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from jepa_tpu_torch.utils import zstd
from jepa_tpu_torch.utils.ocdbt import Store, StoreWriter

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_DICT_KEY = 2  # orbax's key_type of a dict key
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
           "|b1": np.bool_, "bfloat16": np.uint16}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "bfloat16"}
_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"

KeyPath = Tuple[str, ...]


def is_checkpoint(path: str) -> bool:
    """True for a directory holding an orbax checkpoint (a ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _keystr(keypath: KeyPath) -> str:
    """A key path as jax.tree_util.keystr writes one: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in keypath)


def _leaves(path: str) -> Dict[KeyPath, str]:
    """key path -> value_type of every leaf in ``_METADATA``."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: zarr v3 orbax checkpoints are not supported")
    if not meta.get("use_ocdbt"):
        raise NotImplementedError(f"{path}: orbax checkpoints without OCDBT (one "
                                  "tensorstore directory per leaf) are not supported")
    out = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if any(k["key_type"] != _DICT_KEY for k in keys):
            raise NotImplementedError(f"{path}: a tree with other containers than dicts "
                                      f"(key types {[k['key_type'] for k in keys]})")
        out[tuple(k["key"] for k in keys)] = entry["value_metadata"]["value_type"]
    return out


def _store_name(keypath: KeyPath) -> str:
    return ".".join(keypath)


def _zarray(store: Store, name: str) -> dict:
    key = f"{name}/.zarray".encode()
    if key not in store:
        raise KeyError(f"no array {name!r} in the checkpoint's store")
    meta = json.loads(store.read(key).tobytes())
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{name}: zarr format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{name}: zarr order {meta['order']!r} (only C)")
    if meta.get("filters"):
        raise NotImplementedError(f"{name}: zarr filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"{name}: zarr compressor {comp.get('id')!r} "
                                  "(only zstd or none)")
    if meta["dtype"] not in _DTYPES:
        raise NotImplementedError(f"{name}: zarr dtype {meta['dtype']!r}")
    return meta


def _fill(meta: dict) -> Any:
    v = meta.get("fill_value")
    if v is None:
        return 0
    if meta["dtype"] == "bfloat16":  # its bits, as the uint16 the chunks are read into
        return torch.tensor(float(v), dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    return float(v) if isinstance(v, str) else v  # "NaN", "Infinity", "-Infinity"


def _decode(store: Store, key: bytes, meta: dict, out: np.ndarray) -> None:
    """One chunk into ``out`` (C-contiguous, the full chunk's size)."""
    frame = store.read(key)
    if meta.get("compressor") is None:
        if frame.size != out.nbytes:
            raise ValueError(f"{key.decode()}: {frame.size} bytes, expected {out.nbytes}")
        out.reshape(-1).view(np.uint8)[:] = frame
    else:
        zstd.decompress_into(frame, out)


def _read_array(store: Store, name: str) -> np.ndarray:
    meta = _zarray(store, name)
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    whole = chunks == shape
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if shape else '0'}".encode()
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if key not in store:
            out[region] = _fill(meta)
        elif whole:
            _decode(store, key, meta, out)
        else:
            buf = np.empty(chunks, dtype)
            _decode(store, key, meta, buf)
            out[region] = buf[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _array_shape(store: Store, name: str) -> Tuple[int, ...]:
    return tuple(_zarray(store, name)["shape"])


def _nest(items: Dict[KeyPath, Any]) -> dict:
    root: dict = {}
    for kp, v in items.items():
        node = root
        for k in kp[:-1]:
            node = node.setdefault(k, {})
        node[kp[-1]] = v
    return root


def _open(path: str) -> Tuple[str, Dict[KeyPath, str], Store]:
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    leaves = _leaves(path)
    return path, leaves, Store(path)


def _value(store: Store, kp: KeyPath, value_type: str):
    arr = _read_array(store, _store_name(kp))
    return arr[()] if value_type == "scalar" and isinstance(arr, np.ndarray) else arr


def read_tree(path: str, subtree: Optional[Union[str, Sequence[str]]] = None) -> Any:
    """The checkpoint (or the subtree under the key path ``subtree``, a key
    or a sequence of keys) as nested dicts of numpy arrays."""
    path, leaves, store = _open(path)
    prefix = () if subtree is None else (
        (subtree,) if isinstance(subtree, str) else tuple(subtree))
    picked = {kp[len(prefix):]: vt for kp, vt in leaves.items() if kp[:len(prefix)] == prefix}
    if not picked:
        raise KeyError(f"checkpoint {path} has no subtree {_keystr(prefix)}")
    if () in picked:  # the key path names a leaf
        return _value(store, prefix, picked[()])
    return _nest({kp: _value(store, prefix + kp, vt) for kp, vt in picked.items()})


def _flatten(tree, prefix: KeyPath = ()) -> Iterator[Tuple[KeyPath, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _template_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(np.shape(leaf))


def load_subtree(path: str, template: Any) -> Any:
    """STRICTLY read the leaves of ``template`` (nested dicts whose leaves
    are arrays, tensors or shape tuples), as jepa_tpu's load_subtree does:
    a leaf the checkpoint lacks raises KeyError, a shape that differs
    ValueError; no leaf is ever left at a template value. Returns the
    template's structure with the checkpoint's values."""
    path, leaves, store = _open(path)
    flat = list(_flatten(template))
    for kp, leaf in flat:
        if kp not in leaves:
            raise KeyError(f"checkpoint {path} has no leaf {_keystr(kp)} "
                           "(template/checkpoint mismatch)")
        want, got = _template_shape(leaf), _array_shape(store, _store_name(kp))
        if want != got:
            raise ValueError(f"shape mismatch at {_keystr(kp)}: "
                             f"checkpoint {got} vs template {want}")
    return _nest({kp: _value(store, kp, leaves[kp]) for kp, _ in flat})


def _c_order(arr: np.ndarray) -> np.ndarray:
    return arr if arr.flags.c_contiguous else arr.copy(order="C")  # keeps 0-d arrays 0-d


def _leaf_array(v) -> Tuple[np.ndarray, str, str]:
    """(C-contiguous array, zarr dtype, orbax value_type) of a leaf."""
    scalar = isinstance(v, (np.generic, int, float, bool))
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return _c_order(v.view(torch.int16).numpy().view(np.uint16)), "bfloat16", \
                "np.ndarray"
        v = v.numpy()
    arr = _c_order(np.asarray(v))
    if arr.dtype not in _NAMES:
        raise NotImplementedError(f"cannot write dtype {arr.dtype} to an orbax checkpoint")
    return arr, _NAMES[arr.dtype], "scalar" if scalar else "np.ndarray"


def save_tree(path: str, tree: dict) -> None:
    """Write ``tree`` (nested dicts of numpy arrays, torch tensors and
    scalars) as an orbax checkpoint directory at ``path``; an orbax
    checkpoint already there is replaced, as orbax's ``force=True`` does.
    The directory appears whole: it is written beside ``path`` and renamed."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not is_checkpoint(path):
        raise FileExistsError(f"{path} exists and is not an orbax checkpoint")
    t0 = time.time_ns()
    tmp = f"{path}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta: Dict[str, dict] = {}
    with StoreWriter(tmp) as store:
        for kp, leaf in _flatten(tree):
            arr, dtype, value_type = _leaf_array(leaf)
            name = _store_name(kp)
            zarray = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                      "filters": None, "order": "C", "shape": list(arr.shape),
                      "zarr_format": 2}
            store.put(f"{name}/.zarray".encode(),
                      json.dumps(zarray, sort_keys=True, separators=(",", ":")).encode())
            chunk = ".".join("0" for _ in arr.shape) or "0"
            store.put(f"{name}/{chunk}".encode(), zstd.compress(arr, 1))
            tree_meta[str(kp)] = {
                "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in kp],
                "value_metadata": {"value_type": value_type, "skip_deserialize": False}}
    meta = {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
