"""The OCDBT key-value store that orbax checkpoints live in, read and
written with numpy and the system's libzstd (no tensorstore).

A store is a directory. ``manifest.ocdbt`` holds the store's config and
its version tree: the latest generations inline (older ones sit in
version-tree nodes, which reading the latest never needs). A generation
names the root of a B+tree by (data file, offset, length) and its
height. Interior nodes list their children under prefix-compressed keys;
leaf nodes hold key -> value, each value inline in the node or a
(data file, offset, length) reference. Data files are named in each
manifest or node by a table of paths relative to the store's root (an
orbax checkpoint's root node points into ``ocdbt.process_0/d/``).

Every manifest and node is one blob::

    magic      uint32 big-endian (0x0cdb3a2a manifest, 0x0cdb20de node)
    length     uint64 little-endian, of the whole blob
    version    varint, 0
    codec      varint, 0 raw or 1 zstd
    body       (a zstd frame when codec is 1)
    crc32c     uint32 little-endian, of everything before it

and every body field below is a LEB128 varint unless noted. Lists are
stored column by column. The manifest's body::

    config     uuid byte[16], manifest kind (0: the versions live in this
               file), max inline value bytes, max decoded node bytes,
               version tree arity log2 (uint8), compression (0 none, or 1
               zstd followed by its level, int32 little-endian)
    files      a data-file table
    versions   n; generation[n], root height[n] (uint8), root file[n],
               root offset[n], root length[n], keys[n], tree bytes[n],
               out-of-line value bytes[n], commit time[n] (uint64 LE ns)
    nodes      m; the version-tree node references

A data-file table is n; shared prefix with the previous path[n - 1];
suffix length[n]; base-path length[n]; the suffixes. A node's body is its
height (uint8), a data-file table and n entries: key prefix length[n - 1]
(shared with the previous key), key suffix length[n], then for an
interior node the child's common-prefix length[n], the key suffixes, and
child file[n], offset[n], length[n], keys[n], tree bytes[n], out-of-line
value bytes[n]; for a leaf the key suffixes, value length[n], value
kind[n] (0 inline, 1 referenced), then file and offset of each
referenced value and the inline values end to end. Keys in a child omit
the prefix its parent entry's common-prefix length names.

``Store`` reads the latest generation and checks every blob's magic,
length and checksum. ``StoreWriter`` writes one generation: the values out
of line, end to end in one data file, then one leaf node after them, then
the manifest, with the config orbax writes (``ORBAX_CONFIG``), so orbax
opens the store as its own.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from jepa_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
_NO_ROOT = 2**64 - 1


@dataclasses.dataclass(frozen=True)
class Config:
    """A store's config (its manifest's first fields); ``zstd_level`` None
    means the store's blobs are uncompressed (the reader takes both; the
    writer writes ``ORBAX_CONFIG``)."""

    uuid: bytes
    manifest_kind: int = 0
    max_inline_value_bytes: int = 1024
    max_decoded_node_bytes: int = 100_000_000
    version_tree_arity_log2: int = 4
    zstd_level: Optional[int] = 0


# what orbax's PyTreeCheckpointer writes, and all the writer writes (its
# stores differ only in uuid)
ORBAX_CONFIG = Config(uuid=bytes(16))


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object."""
    c, table = 0xFFFFFFFF, _CRC_TABLE
    for x in bytes(data):
        c = table[(c ^ x) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Sequential reads over a node or manifest body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: body ends early")

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} stray bytes")


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _read_blob(data, magic: int, what: str) -> bytes:
    """A blob's body, after checking its magic, length, version and crc."""
    data = bytes(data)
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT blob (magic {data[:4].hex()})")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, found {len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"{what}: checksum mismatch")
    head = _Cursor(data[:-4], what)
    head.pos = 12
    version, codec = head.varint(), head.varint()
    if version != 0:
        raise NotImplementedError(f"{what}: OCDBT format version {version}")
    body = data[head.pos:-4]
    if codec == 0:
        return body
    if codec == 1:
        return zstd.decompress(body).tobytes()
    raise NotImplementedError(f"{what}: OCDBT codec {codec}")


def _write_blob(body: bytes, magic: int) -> bytes:
    """A blob of ``body``, zstd-coded at orbax's level."""
    body = zstd.compress(body, ORBAX_CONFIG.zstd_level).tobytes()
    head = _varint(0) + _varint(1)
    data = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(head) + len(body) + 4)
    data += head + body
    return data + struct.pack("<I", crc32c(data))


def _read_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    if n == 0:
        return []
    shared = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    base = cur.varints(n)  # the base-path part; a path is base + relative
    paths, prev = [], b""
    for k in range(n):
        path = prev[:shared[k]] + cur.take(suffix[k])
        if base[k] > len(path) or path.startswith(b"/") or b".." in path.split(b"/"):
            raise ValueError(f"{cur.what}: data file path {path!r} leaves the store")
        paths.append(path.decode())
        prev = path
    return paths


def _file_table(path: str) -> bytes:
    """A data-file table of one path (relative to the root, no base path)."""
    p = path.encode()
    return _varint(1) + _varint(len(p)) + _varint(0) + p


def _read_keys(cur: _Cursor, n: int, tail=None) -> Tuple[List[bytes], List[int]]:
    """n prefix-compressed keys; ``tail`` reads one more column between the
    lengths and the key bytes (an interior node's common-prefix lengths)."""
    shared = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    extra = tail(n) if tail else []
    keys, prev = [], b""
    for k in range(n):
        if shared[k] > len(prev):
            raise ValueError(f"{cur.what}: key prefix longer than the previous key")
        key = prev[:shared[k]] + cur.take(suffix[k])
        keys.append(key)
        prev = key
    return keys, extra


@dataclasses.dataclass(frozen=True)
class Ref:
    """A value stored out of line: ``length`` bytes at ``offset`` of the
    data file ``path`` (absolute)."""

    path: str
    offset: int
    length: int


def _read_range(path: str, offset: int, length: int) -> np.ndarray:
    out = np.fromfile(path, dtype=np.uint8, count=length, offset=offset)
    if out.size != length:
        raise ValueError(f"{path}: {length} bytes at {offset} run past the file's end")
    return out


class Store:
    """The latest generation of the OCDBT store at ``root``: ``keys()``,
    ``in`` and ``read(key)`` (the value as uint8)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, MANIFEST)
        with open(path, "rb") as f:
            body = _read_blob(f.read(), MANIFEST_MAGIC, path)
        cur = _Cursor(body, path)
        self.config = self._read_config(cur)
        if self.config.manifest_kind != 0:
            raise NotImplementedError(
                f"{path}: OCDBT manifest kind {self.config.manifest_kind} (numbered "
                "manifests) is not supported")
        files = _read_file_table(cur)
        n = cur.varint()
        gen, height = cur.varints(n), [cur.u8() for _ in range(n)]
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(2 * n)  # tree bytes, out-of-line value bytes
        cur.u64s(n)  # commit times
        m = cur.varint()  # older generations, in version-tree nodes
        cur.varints(5 * m)  # generation, file, offset, length, generations
        cur.u64s(m)  # commit times
        cur.take(m)  # heights (uint8)
        cur.done()
        if n == 0:
            raise ValueError(f"{path}: no generation inline")
        last = int(np.argmax(gen))  # the latest generation
        self.generation = gen[last]
        self._values: Dict[bytes, Union[Ref, np.ndarray]] = {}
        if length[last] != _NO_ROOT:
            self._walk(files[fid[last]], off[last], length[last], height[last], b"")
        if len(self._values) != num_keys[last]:
            raise ValueError(f"{path}: the tree holds {len(self._values)} keys, the "
                             f"manifest says {num_keys[last]}")

    @staticmethod
    def _read_config(cur: _Cursor) -> Config:
        uuid = cur.take(16)
        kind, max_inline, max_node = cur.varint(), cur.varint(), cur.varint()
        arity = cur.u8()
        codec = cur.varint()
        if codec == 0:
            level = None
        elif codec == 1:
            (level,) = struct.unpack("<i", cur.take(4))
        else:
            raise NotImplementedError(f"{cur.what}: OCDBT compression method {codec}")
        return Config(uuid, kind, max_inline, max_node, arity, level)

    def _walk(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        path = os.path.join(self.root, rel)
        what = f"{path}@{offset}"
        cur = _Cursor(_read_blob(_read_range(path, offset, length), NODE_MAGIC, what), what)
        if cur.u8() != height:
            raise ValueError(f"{what}: node height differs from its parent's record")
        files = _read_file_table(cur)
        n = cur.varint()
        if height > 0:
            keys, common = _read_keys(cur, n, cur.varints)
            fid, off, ln = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # keys, tree bytes, out-of-line value bytes
            cur.done()
            for k in range(n):
                self._walk(files[fid[k]], off[k], ln[k], height - 1,
                           prefix + keys[k][:common[k]])
            return
        keys, _ = _read_keys(cur, n)
        sizes, kinds = cur.varints(n), cur.varints(n)
        if any(kind not in (0, 1) for kind in kinds):
            raise NotImplementedError(f"{what}: value kind other than inline / referenced")
        m = sum(kinds)
        fid, off = cur.varints(m), cur.varints(m)
        refs = iter(zip(fid, off))
        for key, size, kind in zip(keys, sizes, kinds):
            if kind:
                f, o = next(refs)
                val = Ref(os.path.join(self.root, files[f]), o, size)
            else:
                val = np.frombuffer(cur.take(size), np.uint8)
            self._values[prefix + key] = val
        cur.done()

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def read(self, key: bytes) -> np.ndarray:
        """The value of ``key`` as a uint8 array (raises KeyError)."""
        val = self._values[key]
        if isinstance(val, Ref):
            return _read_range(val.path, val.offset, val.length)
        return val


class StoreWriter:
    """Write a new store at ``root`` (an empty or missing directory) as one
    generation: ``put`` appends each value to one data file as it comes;
    ``close`` (or leaving the ``with`` block) writes the leaf node and then
    the manifest, so a store without a manifest is one that never finished."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        if os.path.exists(os.path.join(self.root, MANIFEST)):
            raise FileExistsError(f"{self.root} already holds an OCDBT store")
        self.config = dataclasses.replace(ORBAX_CONFIG, uuid=os.urandom(16))
        self.data_rel = f"d/{os.urandom(16).hex()}"
        os.makedirs(os.path.join(self.root, "d"), exist_ok=True)
        self._file = open(os.path.join(self.root, self.data_rel), "wb")
        self._entries: Dict[bytes, Tuple[int, int]] = {}
        self._offset = 0

    def put(self, key: bytes, value) -> None:
        if key in self._entries:
            raise KeyError(f"duplicate key {key!r}")
        arr = value if isinstance(value, np.ndarray) else np.frombuffer(value, np.uint8)
        buf = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        self._file.write(buf)
        self._entries[key] = (self._offset, buf.nbytes)
        self._offset += buf.nbytes

    def _node(self) -> bytes:
        keys = sorted(self._entries)
        shared = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
        body = bytes([0]) + _file_table(self.data_rel) + _varint(len(keys))
        body += _varints(shared)
        body += _varints(len(k) - s for k, s in zip(keys, [0] + shared))
        body += b"".join(k[s:] for k, s in zip(keys, [0] + shared))
        body += _varints(self._entries[k][1] for k in keys)
        body += _varints(1 for _ in keys)  # every value referenced
        body += _varints(0 for _ in keys)  # all in data file 0
        body += _varints(self._entries[k][0] for k in keys)
        if len(body) > self.config.max_decoded_node_bytes:
            raise ValueError(f"{len(keys)} keys overflow one OCDBT leaf node")
        return body

    def close(self) -> None:
        if self._file is None:
            return
        c = self.config
        node = _write_blob(self._node(), NODE_MAGIC)
        node_offset = self._offset
        self._file.write(node)
        self._file.flush()
        os.fsync(self._file.fileno())
        self._file.close()
        self._file = None
        body = (c.uuid + _varint(c.manifest_kind) + _varint(c.max_inline_value_bytes)
                + _varint(c.max_decoded_node_bytes) + bytes([c.version_tree_arity_log2])
                + _varint(1) + struct.pack("<i", c.zstd_level))  # zstd at its level
        body += _file_table(self.data_rel)
        body += _varint(1) + _varint(1) + bytes([0])  # generation 1, a root of height 0
        body += _varints([0, node_offset, len(node), len(self._entries), len(node),
                          node_offset])
        body += struct.pack("<Q", time.time_ns()) + _varint(0)
        tmp = os.path.join(self.root, f"{MANIFEST}.tmp{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(_write_blob(body, MANIFEST_MAGIC))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, MANIFEST))

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        elif self._file is not None:
            self._file.close()
            self._file = None
