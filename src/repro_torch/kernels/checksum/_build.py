"""Build and load the checksum kernels (`csrc/checksum.cu`).

The source has a plain C interface, so it is compiled by `nvcc -shared`
alone (seconds; no PyTorch headers) into `build/torch_kernels/` at the
root of the checkout and loaded with ctypes. The library's file name
carries a hash of the source and flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing is built at import time:
`lib()` builds on first use, from the launching wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "checksum.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(_HERE)))), "build", "torch_kernels")
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build did: {"path", "seconds", "log"}; empty until lib()
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the checksum kernels are built "
                           "from source and need the CUDA toolkit")
    return path


def _compile() -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libchecksum_{tag}.so")
    if os.path.exists(out):
        build_info.update(path=out, seconds=0.0, log="(cached)")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(path=out, seconds=time.monotonic() - t0,
                      log=proc.stdout + proc.stderr)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(_compile())
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            so.rt_tile_checksums.argtypes = [p, i64, i64, p, p]
            so.rt_checksum_words.argtypes = [p, i64, i32, p, p]
            so.rt_gather_tiles.argtypes = [p, i64, p, i64, p, p]
            for fn in (so.rt_tile_checksums, so.rt_checksum_words,
                       so.rt_gather_tiles):
                fn.restype = i32
            so.rt_error_string.argtypes = [i32]
            so.rt_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib().rt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({code})")
