"""Build and load the port's CUDA kernels.

All sources under ``jepa_tpu_torch/csrc/*.cu`` are compiled by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). The build runs
at first use and lands in ``jepa_tpu_torch/build/``, named by a hash of the
sources and flags, so an edited source is never served by a stale library.

    lib = load_library()          # builds if needed
    lib.jt_flash_fwd_c64(...)     # argtypes set below

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every entry point returns cudaError_t (int)
# H1, H2, H1-fp32 and H2-fp32 (ops.flash_attention.KERNEL_HEAD_DIMS, F32_HEAD_DIMS,
# F32_BWD_HEAD_DIMS)
_TM_HEAD_DIMS = (32, 64, 80, 96, 128)
_SIGNATURES = {
    # qkv, key mask (None: unmasked), o, lse, B, N, H, scale*log2e, stream
    **{f"jt_flash_fwd_c{c}": [_P, _P, _P, _P, _I, _I, _I, _F, _P] for c in _TM_HEAD_DIMS},
    # qkv, key mask, do, lse, delta, dqkv, B, N, H, scale*log2e, stream
    **{f"jt_flash_bwd_dkv_c{c}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
       for c in _TM_HEAD_DIMS},
    # qkv, key mask, do, lse, delta, dqkv, B, N, H, scale*log2e, scale, stream
    **{f"jt_flash_bwd_dq_c{c}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P]
       for c in _TM_HEAD_DIMS},
    # head-major H4-H7 and H4-H7-fp32: a pointer to the HmArgs struct
    # (ops/flash_attention.py), stream
    **{f"jt_flash_hm_{kind}{dt}_c{c}": [_P, _P]
       for kind in ("fwd", "dq", "dkv", "dqkv") for dt in ("", "_f32") for c in (16, 32, 64)},
    # H1-fp32: fp32 qkv, key mask (None: unmasked), o, lse, B, N, H, scale*log2e,
    # stream (ops.flash_attention.F32_HEAD_DIMS)
    **{f"jt_flash_fwd_f32_c{c}": [_P, _P, _P, _P, _I, _I, _I, _F, _P] for c in _TM_HEAD_DIMS},
    # H2-fp32, the bf16 H2 entries' arguments (ops.flash_attention.F32_BWD_HEAD_DIMS)
    **{f"jt_flash_bwd_dkv_f32_c{c}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
       for c in _TM_HEAD_DIMS},
    **{f"jt_flash_bwd_dq_f32_c{c}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P]
       for c in _TM_HEAD_DIMS},
    # x, w, b, out, M, K, F, stream
    "jt_linear_gelu_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "jt_linear_gelu_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, w, b, out, z, M, K, F, stream
    "jt_linear_gelu_z_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "jt_linear_gelu_z_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the library if no up-to-date build exists; return its path.
    Each source compiles in its own nvcc process, all started together,
    then one nvcc links the objects."""
    global build_seconds
    out = BUILD_DIR / f"libjepa_tpu_torch_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    if verbose:
        compile_flags = ["-Xptxas=-v", *compile_flags]
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors, notes = [], []
    for src, proc in zip(_sources(), procs):
        _, err = proc.communicate()
        (errors if proc.returncode else notes).append(f"{src.name}:\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    if verbose:
        print("\n".join(notes))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
