"""ctypes bindings for the native FFmpeg decoder (counterpart of
jepa_tpu/native/videodec.py).

The library (``videodec.cpp``) is built at first use by
``native.build``. The decode call releases the GIL (ctypes does this for
foreign calls), so the threaded loader gets true decode parallelism: the
role decord's C++ core plays in the reference
(reference: src/datasets/video_dataset.py).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from jepa_tpu_torch.data.video_dataset import letterbox, scaled_size

_LIB = None
_LIB_LOCK = threading.Lock()


def _load() -> ctypes.CDLL:
    """The decode library, built on first use (raises if it cannot be)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from jepa_tpu_torch.native.build import build

        lib = ctypes.CDLL(str(build()))
        lib.jdec_open_threads.restype = ctypes.c_void_p
        lib.jdec_open_threads.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.jdec_info.restype = ctypes.c_int
        lib.jdec_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.jdec_read_frames.restype = ctypes.c_int
        lib.jdec_read_frames.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.jdec_close.restype = None
        lib.jdec_close.argtypes = [ctypes.c_void_p]
        lib.jdec_encode_test_video.restype = ctypes.c_int
        lib.jdec_encode_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int,
        ]
        lib.jdec_encode_frames.restype = ctypes.c_int
        lib.jdec_encode_frames.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ]
        _LIB = lib
        return lib


class VideoReader:
    """Decord-shaped reader: probe + batched random-access frame gather."""

    def __init__(self, path: str, threads: int = 0):
        """threads: codec threads per stream; 0 = auto (all cores). Loader
        pools pass a small value so parallelism comes from many streams."""
        self._lib = _load()
        self._h = self._lib.jdec_open_threads(path.encode(), int(threads))
        if not self._h:
            raise IOError(f"failed to open video: {path}")
        n = ctypes.c_longlong()
        fps = ctypes.c_double()
        w = ctypes.c_int()
        h = ctypes.c_int()
        self._lib.jdec_info(self._h, ctypes.byref(n), ctypes.byref(fps),
                            ctypes.byref(w), ctypes.byref(h))
        self.num_frames = int(n.value)
        self.fps = float(fps.value)
        self.width = int(w.value)
        self.height = int(h.value)

    def __len__(self):
        return self.num_frames

    def get_avg_fps(self) -> float:
        return self.fps

    def get_batch(self, indices, out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """indices (sorted ascending internally) -> uint8 [n, H, W, 3], in
        the order given. out_size (h, w) resizes during the colour
        conversion (free with sws_scale)."""
        idx = np.asarray(indices, dtype=np.int64)
        order = np.argsort(idx, kind="stable")
        sorted_idx = np.ascontiguousarray(idx[order])
        oh, ow = out_size if out_size else (self.height, self.width)
        out = np.empty((len(idx), oh, ow, 3), np.uint8)
        rc = self._lib.jdec_read_frames(
            self._h,
            sorted_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            ow,
            oh,
        )
        if rc < 0:
            raise IOError(f"decode failed (rc={rc})")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return out[inv]

    def close(self):
        if self._h:
            self._lib.jdec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBackend:
    """Decode backend for ``data.video_dataset`` (probe / decode).

    Two geometry modes:
      * fixed canvas (``out_size``): every video scales to one (H, W),
        distorting other aspect ratios; the cheapest;
      * aspect-preserving (``short_side`` + ``canvas``): per video, scale so
        the short side is ``short_side`` (capped so the frame fits the
        canvas), sws_scale to that size, letterbox top-left into a zeroed
        canvas, with the (h', w') sidecar the device crops honour
        (reference evals/video_classification_frozen/utils.py:286-323).
    """

    def __init__(self, out_size: Optional[Tuple[int, int]] = None, threads: int = 2,
                 short_side: Optional[int] = None,
                 canvas: Optional[Tuple[int, int]] = None):
        _load()  # fail fast if the library can't be built
        self.out_size = out_size
        self.threads = threads
        self.short_side = short_side
        self.canvas = canvas if canvas is not None else (
            (2 * short_side, 2 * short_side) if short_side else None
        )

    def probe(self, path: str):
        r = VideoReader(path, threads=1)
        try:
            return r.num_frames, r.fps
        finally:
            r.close()

    def decode(self, path: str, indices: np.ndarray) -> np.ndarray:
        r = VideoReader(path, threads=self.threads)
        try:
            return r.get_batch(indices, out_size=self.out_size)
        finally:
            r.close()

    def decode_aspect(self, path: str, indices: np.ndarray):
        """Aspect-preserving decode -> (frames [T, Hc, Wc, 3], (h', w'))."""
        r = VideoReader(path, threads=self.threads)
        try:
            hp, wp = scaled_size(r.height, r.width, self.short_side, self.canvas)
            frames = r.get_batch(indices, out_size=(hp, wp))
        finally:
            r.close()
        return letterbox(frames, self.canvas), (hp, wp)


def write_video(path: str, frames: np.ndarray, fps: float = 30.0):
    """Encode RGB frames [T, H, W, 3] uint8 to an mpeg4 file. mpeg4 is
    lossy: pixel values are approximate after a decode round trip."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [T, H, W, 3] uint8, got {frames.shape}")
    t, h, w, _ = frames.shape
    rc = _load().jdec_encode_frames(
        path.encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        t, w, h, fps,
    )
    if rc != 0:
        raise IOError(f"encode failed (rc={rc})")


def write_test_video(path: str, num_frames=64, width=192, height=128, fps=30.0, seed=0):
    """Deterministic mpeg4 fixture (pattern: R=x+2t, G=y+3t, B=x+y+t mod 256)."""
    rc = _load().jdec_encode_test_video(path.encode(), num_frames, width, height, fps, seed)
    if rc != 0:
        raise IOError(f"encode failed (rc={rc})")


def expected_test_pixel(x: int, y: int, t: int, seed: int = 0):
    """Ground-truth RGB of write_test_video before codec loss."""
    return ((x + 2 * t + seed) & 0xFF, (y + 3 * t + 2 * seed) & 0xFF, (x + y + t) & 0xFF)
