"""Dispatch for the checkpoint checksum and the dirty-tile gather.

Every entry point computes the functions defined in `ref.py`:

  - host numpy arrays  -> the vectorized numpy reference (`ref.py`)
  - CPU tensors        -> the plain PyTorch versions below
  - CUDA tensors       -> the hand-written kernels in `csrc/checksum.cu`
                          (K1 tile digests, K2 whole-leaf digest, K3 gather)

A CUDA tensor always goes to its kernel, whatever its size; a build or
launch failure raises. Tensors on any other device raise.

The word stream is the tensor's little-endian byte stream: bool as uint8,
every 1/2/4/8-byte dtype (bfloat16 included) by its bits, zero-padded to
whole words and whole 4 KB tiles — the stream `ref.byte_view` gives for
the same array. Digest words travel as int32 tensors holding uint32 bits
and become numpy uint32 on the host.

The plain versions compute in int64 masked to 32 bits, since PyTorch has
no wrapping uint32 arithmetic. They are what the CPU tests hold against
the JAX package, and what `chip_smoke.py` holds the kernels against on the
card; nothing on the CUDA path calls them.
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import check, lib
from .ref import (MIX_C, TILE_BYTES, TILE_WORDS, checksum_words_ref, n_tiles,
                  tile_checksums_ref)

M32 = 0xFFFFFFFF

#: kernel launches per wrapper; only the CUDA branch of each wrapper counts
LAUNCHES = {"tile_checksums": 0, "checksum_words": 0, "gather_tiles": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def byte_stream(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor's bytes (copies only if it is not
    contiguous). Raises TypeError for an itemsize the checksum does not
    define, before anything is launched."""
    if x.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"unsupported itemsize {x.element_size()} "
                        f"for dtype {x.dtype}")
    if x.numel() == 0:          # an empty tensor may carry zero strides
        return torch.empty(0, dtype=torch.uint8, device=x.device)
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same low bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for int64 operands in [0, 2^32) without overflow:
    split a into 16-bit halves so no partial product reaches 2^63."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _tiles_plain(b: torch.Tensor) -> torch.Tensor:
    """uint8 stream -> (n_tiles, TILE_WORDS) int32 words, zero-padded."""
    nt = n_tiles(b.numel())
    padded = torch.zeros(nt * TILE_BYTES, dtype=torch.uint8, device=b.device)
    padded[:b.numel()] = b
    return padded.view(torch.int32).reshape(nt, TILE_WORDS)


def _linear_sums(w: torch.Tensor):
    """Per-tile s0 = sum w and s1 = sum (j+1) w (mod 2^32) of int64 words
    in [0, 2^32)."""
    j1 = torch.arange(1, TILE_WORDS + 1, dtype=torch.int64, device=w.device)
    return w.sum(1) & M32, (w * j1).sum(1) & M32


def tile_checksums_plain(b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: (n_tiles, 3) int32 rows (s0, s1, m)."""
    w = _tiles_plain(b).to(torch.int64) & M32
    s0, s1 = _linear_sums(w)
    m = _mul32(w ^ (w >> 16), int(MIX_C)).sum(1) & M32
    return _to_i32(torch.stack([s0, s1, m], dim=1))


def checksum_words_plain(b: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (2,) int32 (s0, s1) of the whole stream,
    folded from per-tile sums: s1 = sum_t s1_t + (t*W) * s0_t."""
    t0, t1 = _linear_sums(_tiles_plain(b).to(torch.int64) & M32)
    base = (torch.arange(t0.numel(), dtype=torch.int64, device=b.device)
            * TILE_WORDS) & M32
    s0 = t0.sum() & M32
    s1 = (t1 + _mul32(base, t0)).sum() & M32
    return _to_i32(torch.stack([s0, s1]))


def gather_tiles_plain(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (k, TILE_WORDS) int32, row i = tile idx[i]."""
    return _tiles_plain(b)[idx.long()]


# ------------------------------------------------------------ kernels

def _aligned(b: torch.Tensor) -> torch.Tensor:
    """Check what the kernels take — a non-empty, contiguous, 1-D uint8
    CUDA stream — and return it 16-byte aligned (the kernels read 16-byte
    vectors; a fresh allocation is aligned)."""
    if not (b.is_cuda and b.dtype == torch.uint8 and b.dim() == 1
            and b.is_contiguous() and b.numel() > 0):
        raise ValueError("the checksum kernels take a non-empty contiguous "
                         f"1-D uint8 CUDA tensor, got {b.dtype} "
                         f"{tuple(b.shape)} on {b.device}")
    return b if b.data_ptr() % 16 == 0 else b.clone()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tile_checksums_kernel(b: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA uint8 stream -> (n_tiles, 3) int32 device rows."""
    b = _aligned(b)
    nt = n_tiles(b.numel())
    out = torch.empty((nt, 3), dtype=torch.int32, device=b.device)
    code = lib().rt_tile_checksums(b.data_ptr(), b.numel(), nt,
                                   out.data_ptr(), _stream(b))
    check(code, "tile_checksums")
    LAUNCHES["tile_checksums"] += 1
    return out


def checksum_words_kernel(b: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA uint8 stream -> (2,) int32 device (s0, s1)."""
    b = _aligned(b)
    out = torch.zeros(2, dtype=torch.int32, device=b.device)
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    code = lib().rt_checksum_words(b.data_ptr(), b.numel(), sms,
                                   out.data_ptr(), _stream(b))
    check(code, "checksum_words")
    LAUNCHES["checksum_words"] += 1
    return out


def gather_tiles_kernel(b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3 on a CUDA uint8 stream and (k,) int32 CUDA tile indices, each
    below the stream's tile count (`gather_tiles_device` checks them on
    the host) -> (k, TILE_WORDS) int32 device buffer."""
    b = _aligned(b)
    if not (idx.device == b.device and idx.dtype == torch.int32
            and idx.dim() == 1 and idx.is_contiguous()):
        raise ValueError("gather_tiles_kernel takes (k,) int32 tile indices "
                         "on the stream's device")
    k = idx.numel()
    out = torch.empty((k, TILE_WORDS), dtype=torch.int32, device=b.device)
    if k == 0:
        return out
    code = lib().rt_gather_tiles(b.data_ptr(), b.numel(), idx.data_ptr(), k,
                                 out.data_ptr(), _stream(b))
    check(code, "gather_tiles")
    LAUNCHES["gather_tiles"] += 1
    return out


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise RuntimeError(f"no checksum kernel for device {x.device}")


# ------------------------------------------------------- entry points

def tile_checksums_device(x: torch.Tensor):
    """Per-4KB-tile (s0, s1, mix) digests of a tensor, computed where it
    lives and returned there as (n_tiles, 3) int32 (uint32 bits); None for
    an empty tensor. The delta checkpointer enqueues this beside the D2H
    drain and reads the 12 B/tile result on its writer thread."""
    b = byte_stream(x)
    if b.numel() == 0:
        return None
    if _route(x) == "cuda":
        return tile_checksums_kernel(b)
    return tile_checksums_plain(b)


def checksum_words_device(x: torch.Tensor):
    """(s0, s1) of a tensor's byte stream as a (2,) int32 tensor on its
    device, without a host sync; None for an empty tensor."""
    b = byte_stream(x)
    if b.numel() == 0:
        return None
    if _route(x) == "cuda":
        return checksum_words_kernel(b)
    return checksum_words_plain(b)


def gather_tiles_device(x: torch.Tensor, idx) -> torch.Tensor:
    """Gather the 4 KB tiles named by `idx` (host int array, ascending)
    into one compact (len(idx), TILE_WORDS) int32 buffer on the tensor's
    device — the delta checkpointer's dirty-tile gather, so the D2H copy
    that follows moves only dirty tiles."""
    b = byte_stream(x)
    idx = np.asarray(idx, np.int64)
    nt = n_tiles(b.numel())
    if idx.size and (idx.min() < 0 or idx.max() >= nt):
        raise IndexError(f"tile index out of range [0, {nt})")
    route = _route(x)
    t_idx = torch.as_tensor(idx.astype(np.int32), device=x.device)
    if route == "cuda":
        return gather_tiles_kernel(b, t_idx)
    return gather_tiles_plain(b, t_idx)


def host_u32(t) -> np.ndarray:
    """Digest words on a device (int32 holding uint32 bits) -> numpy
    uint32; None (an empty leaf's rows) -> (0, 3)."""
    if t is None:
        return np.zeros((0, 3), np.uint32)
    return t.cpu().numpy().view(np.uint32)


def checksum_words(x: torch.Tensor) -> tuple[int, int]:
    """(s0, s1) of a tensor's byte stream as Python ints."""
    s = checksum_words_device(x)
    if s is None:
        return 0, 0
    s0, s1 = host_u32(s).tolist()
    return int(s0), int(s1)


def tile_checksums(arr) -> np.ndarray:
    """Per-tile digests as a host (n_tiles, 3) uint32 array: tensors are
    digested on their device, host arrays by the numpy reference."""
    if isinstance(arr, torch.Tensor):
        return host_u32(tile_checksums_device(arr))
    return tile_checksums_ref(np.asarray(arr))


def leaf_checksum(arr) -> tuple[int, int]:
    """(s0, s1) entry point used by checkpoint.manifest."""
    if isinstance(arr, torch.Tensor):
        return checksum_words(arr)
    return checksum_words_ref(np.asarray(arr))

