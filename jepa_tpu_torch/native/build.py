"""Build the native video decode library: ``python -m jepa_tpu_torch.native.build``.

Compiles ``videodec.cpp`` against the system FFmpeg libraries (libavformat,
libavcodec, libavutil, libswscale and their headers) with g++ into
``jepa_tpu_torch/build/libjepadec_<hash>.so``, named by a hash of the
source and the command, so an edited source is never served by a stale
library. The build runs at first use (``videodec._load``); concurrent
processes take a file lock, so one compiles and the others wait and load
its output, which lands by ``os.replace`` of a temporary file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "videodec.cpp"
BUILD_DIR = HERE.parent / "build"
LIBS = ["avformat", "avcodec", "avutil", "swscale"]
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libjepadec_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library if no up-to-date build exists; return its path.
    Raises ``RuntimeError`` with g++'s output when the compile fails (no
    FFmpeg headers or libraries, for instance)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libjepadec.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp), *(f"-l{lib}" for lib in LIBS)]
        if verbose:
            print("+", " ".join(cmd))
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the video decoder failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build(verbose='-v' in sys.argv)}")
