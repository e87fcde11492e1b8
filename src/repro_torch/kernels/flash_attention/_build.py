"""Build and load the flash-attention kernel (`csrc/flash_attention.cu`)
through the port's shared builder (`repro_torch.kernels._build`): `nvcc
-shared` into `build/torch_kernels/` on first use, loaded with ctypes."""
from __future__ import annotations

import ctypes
import os

from .._build import KernelLib

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")


def _declare(so: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # q, k, v, o; dtype, B, H, Hkv, Sq, Sk, hd; (batch, seq, head) element
    # strides of q, k, v, o; causal, scale, stream
    so.rt_flash_attention.argtypes = [p, p, p, p, *[i32] * 7, *[i64] * 12,
                                      i32, ctypes.c_float, p]
    so.rt_flash_attention.restype = i32


KERNELS = KernelLib(SOURCE, "flash_attention", _declare)
