"""Build and load the selective-scan kernel (`csrc/selective_scan.cu`)
through the port's shared builder (`repro_torch.kernels._build`): `nvcc
-shared` into `build/torch_kernels/` on first use, loaded with ctypes."""
from __future__ import annotations

import ctypes
import os

from .._build import KernelLib

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "selective_scan.cu")


def _declare(so: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    so.rt_selective_scan.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32,
                                     p]
    so.rt_selective_scan.restype = i32
    so.rt_selective_scan_occupancy.argtypes = [i32, i32, p, p]
    so.rt_selective_scan_occupancy.restype = i32


KERNELS = KernelLib(SOURCE, "selective_scan", _declare)
