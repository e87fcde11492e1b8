"""Build and load the port's CUDA kernels (`<kernel>/csrc/*.cu`).

Each source has a plain C interface, so it is compiled by `nvcc -shared`
alone (seconds; no PyTorch headers) into `build/torch_kernels/` at the
root of the checkout and loaded with ctypes. A library's file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing is built at import time:
`KernelLib.lib()` builds on first use, from the launching wrapper.
Separate `KernelLib`s build independently, so their `nvcc` runs may be
started together from threads.

Every source exports `const char* rt_error_string(int code)`, which
`check` uses to name the CUDA error a launch returned.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "torch_kernels")
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source and need the CUDA toolkit")
    return path


def _compile(source: str, stem: str, info: dict) -> str:
    """Compile `source` into `BUILD_DIR/lib<stem>_<hash>.so` unless that
    file exists; record {"path", "seconds", "log"} in `info`."""
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    if os.path.exists(out):
        info.update(path=out, seconds=0.0, log="(cached)")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {os.path.basename(source)} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    info.update(path=out, seconds=time.monotonic() - t0,
                log=proc.stdout + proc.stderr)
    return out


class KernelLib:
    """One kernel source, built on first use and loaded once.

    `declare(so)` sets `argtypes`/`restype` of the source's entry points.
    `info` holds what the build did: {"path", "seconds", "log"}."""

    def __init__(self, source: str, stem: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.source, self.stem, self._declare = source, stem, declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.info: dict = {}

    def lib(self) -> ctypes.CDLL:
        """The loaded kernel library, built on first call."""
        if self._lib is not None:        # the launch path: no lock
            return self._lib
        with self._lock:
            if self._lib is None:
                so = ctypes.CDLL(_compile(self.source, self.stem, self.info))
                self._declare(so)
                so.rt_error_string.argtypes = [ctypes.c_int]
                so.rt_error_string.restype = ctypes.c_char_p
                self._lib = so
            return self._lib

    def check(self, code: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if code != 0:
            msg = self.lib().rt_error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({code})")
