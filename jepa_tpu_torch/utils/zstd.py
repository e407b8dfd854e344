"""ctypes binding to the system's libzstd (``libzstd.so.1``): the codec of
orbax's zarr chunks and of OCDBT's manifests and B-tree nodes.

``decompress_into`` decodes one frame straight into a preallocated numpy
buffer of the exact decoded size (zarr's chunk frames carry no content
size, so the size comes from the array's ``.zarray``); ``decompress``
decodes a frame of any size, streaming where its header states none
(OCDBT's manifests and nodes); ``compress`` writes one frame. The calls release the GIL, as
every ctypes foreign call does. A missing library raises ``OSError``
naming it: there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

_LIB = None
_LIB_LOCK = threading.Lock()


class _Buffer(ctypes.Structure):
    """ZSTD_inBuffer / ZSTD_outBuffer: (pointer, size, position)."""

    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _load() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError:
            found = ctypes.util.find_library("zstd")
            if found is None:
                raise OSError(f"{LIBRARY} (the zstd library) is not installed; "
                              "orbax checkpoints cannot be read or written") from None
            lib = ctypes.CDLL(found)
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        lib.ZSTD_versionNumber.argtypes = []
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
        lib.ZSTD_compress.restype = size_t
        lib.ZSTD_compress.argtypes = [vp, size_t, vp, size_t, ctypes.c_int]
        lib.ZSTD_compressBound.restype = size_t
        lib.ZSTD_compressBound.argtypes = [size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
        lib.ZSTD_createDStream.restype = vp
        lib.ZSTD_createDStream.argtypes = []
        lib.ZSTD_freeDStream.restype = size_t
        lib.ZSTD_freeDStream.argtypes = [vp]
        lib.ZSTD_initDStream.restype = size_t
        lib.ZSTD_initDStream.argtypes = [vp]
        lib.ZSTD_decompressStream.restype = size_t
        lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]
        _LIB = lib
        return lib


def version() -> str:
    """The loaded library's version, e.g. '1.5.4'."""
    n = _load().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def _bytes_view(buf) -> np.ndarray:
    """A uint8 view of any C-contiguous buffer (bytes, memoryview, numpy)."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError("zstd buffers must be C-contiguous")
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what} failed: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress_into(frame, out: np.ndarray) -> None:
    """Decode the zstd ``frame`` into ``out`` (C-contiguous, written in
    place), which must be exactly the decoded size."""
    lib = _load()
    src, dst = _bytes_view(frame), _bytes_view(out)
    if not dst.flags.writeable:
        raise ValueError("zstd output buffer is read-only")
    n = _check(lib, lib.ZSTD_decompress(dst.ctypes.data, dst.size, src.ctypes.data, src.size),
               "decompression")
    if n != dst.size:
        raise ValueError(f"zstd frame decoded to {n} bytes, expected {dst.size}")


def decompress(frame) -> np.ndarray:
    """Decode one frame, as uint8."""
    lib = _load()
    src = _bytes_view(frame)
    size = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd decompression failed: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN:
        out = np.empty(size, np.uint8)
        decompress_into(src, out)
        return out
    stream = lib.ZSTD_createDStream()
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "decompression")
        out = np.empty(max(1 << 16, 4 * src.size), np.uint8)
        inp = _Buffer(src.ctypes.data, src.size, 0)
        outb = _Buffer(out.ctypes.data, out.size, 0)
        while True:
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                         ctypes.byref(inp)), "decompression")
            if left == 0:  # the frame is complete
                return out[:outb.pos]
            if outb.pos == outb.size:
                out = np.concatenate([out, np.empty_like(out)])
                outb = _Buffer(out.ctypes.data, out.size, outb.pos)
            elif inp.pos == inp.size:
                raise ValueError("zstd decompression failed: the frame is truncated")
    finally:
        lib.ZSTD_freeDStream(stream)


def compress(buf, level: int = 1) -> np.ndarray:
    """One zstd frame (content size in its header) of ``buf``, as uint8."""
    lib = _load()
    src = _bytes_view(buf)
    out = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    n = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.size, src.ctypes.data, src.size,
                                      level), "compression")
    return out[:n]
