"""Build and load the checksum kernels (`csrc/checksum.cu`) through the
port's shared builder (`repro_torch.kernels._build`): `nvcc -shared` into
`build/torch_kernels/` on first use, loaded with ctypes."""
from __future__ import annotations

import ctypes
import os

from .._build import KernelLib

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "checksum.cu")


def _declare(so: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    so.rt_tile_checksums.argtypes = [p, i64, i64, p, p]
    so.rt_checksum_words.argtypes = [p, i64, i32, p, p]
    so.rt_gather_tiles.argtypes = [p, i64, p, i64, p, p]
    for fn in (so.rt_tile_checksums, so.rt_checksum_words,
               so.rt_gather_tiles):
        fn.restype = i32


KERNELS = KernelLib(SOURCE, "checksum", _declare)
