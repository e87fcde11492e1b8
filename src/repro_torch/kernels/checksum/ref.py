"""Numpy reference for the word-sum checkpoint checksum.

The checksum is defined over the little-endian byte stream of a
C-contiguous array, zero-padded to a multiple of 4 bytes and read as
uint32 words w[0..n):

    s0 = sum_i w_i                  (mod 2^32)
    s1 = sum_i (i + 1) * w_i        (mod 2^32)

s0 is the Fletcher-style content sum; the (i+1) weighting in s1 makes the
pair order-sensitive (a swap of two unequal words changes s1) while both
terms stay pure tiled reductions — each tile contributes

    s1_tile = local_weighted_sum + tile_base_index * s0_tile

so the whole digest parallelizes over VMEM-resident tiles on device and
over vectorized chunks here. Trailing zero words alias with padding, which
is harmless: the digest string mixes in dtype and shape (hence byte
length) before hashing.

This module is pure numpy — it is both the host fallback used by
`checkpoint.manifest` for host-resident leaves and the oracle the Pallas
kernel is tested against.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
_CHUNK_WORDS = 1 << 20          # 4 MB per chunk keeps temporaries cache-friendly

# Delta-checkpoint tile: 1024 words = 4 KB. Matches the Pallas kernel's
# (8, 128) grid block exactly, so one device pass yields both the per-tile
# digests and (via scalar_from_tiles) the whole-leaf digest.
TILE_WORDS = 1 << 10
TILE_BYTES = TILE_WORDS * 4


def byte_view(arr: np.ndarray) -> np.ndarray:
    """Flat uint8 view of the array's bytes (copy only if non-contiguous).
    Shared by the digest path and checkpoint serde so both always see the
    identical byte stream."""
    a = np.ascontiguousarray(arr)
    return a.reshape(-1).view(np.uint8)


_ARANGE = np.arange(1, _CHUNK_WORDS + 1, dtype=np.uint32)   # reused weights


def checksum_words_ref(arr: np.ndarray) -> tuple[int, int]:
    """(s0, s1) word-sums of `arr`'s byte stream. Vectorized, no tobytes.

    Per chunk at base index B:  sum(w * (B + j)) = sum(w * j) + B * sum(w)
    (all mod 2^32), so each chunk needs one uint32 wrap-multiply by a
    precomputed 1..N weight vector and two SIMD sums — no uint64
    temporaries, ~4 memory passes total.
    """
    b = byte_view(np.asarray(arr))
    nbytes = b.size
    n_main = (nbytes // 4) * 4
    s0 = 0
    s1 = 0
    words = b[:n_main].view(np.uint32)
    for start in range(0, words.size, _CHUNK_WORDS):
        w = words[start:start + _CHUNK_WORDS]
        c0 = int(w.sum(dtype=np.uint64)) & M32
        local = int(np.multiply(w, _ARANGE[:w.size], dtype=np.uint32)
                    .sum(dtype=np.uint64)) & M32
        s0 = (s0 + c0) & M32
        s1 = (s1 + local + start * c0) & M32
    tail = b[n_main:]
    if tail.size:
        w_tail = int.from_bytes(tail.tobytes(), "little")
        i_tail = words.size + 1
        s0 = (s0 + w_tail) & M32
        s1 = (s1 + i_tail * w_tail) & M32
    return s0, s1


_TILE_ARANGE = np.arange(1, TILE_WORDS + 1, dtype=np.uint32)

# Odd (invertible mod 2^32) diffusion constant for the nonlinear mix
# column — the golden-ratio multiplier.
MIX_C = np.uint32(0x9E3779B1)


def n_tiles(nbytes: int) -> int:
    """Tile count of an nbytes-long byte stream (ceil over 4 KB tiles)."""
    return max(1, -(-nbytes // TILE_BYTES)) if nbytes else 0


def _mix(w: np.ndarray) -> np.ndarray:
    """Nonlinear per-word mix: x ^= x >> 16; x *= MIX_C (mod 2^32)."""
    return np.multiply(w ^ (w >> np.uint32(16)), MIX_C, dtype=np.uint32)


def tile_checksums_ref(arr: np.ndarray) -> np.ndarray:
    """Per-tile (s0, s1, m) digests of `arr`'s byte stream.

    Each TILE_WORDS-word tile is digested as a standalone word stream:
    s0/s1 are the local-weighted word-sum pair of `checksum_words_ref`
    (so `scalar_from_tiles` folds them back into the whole-leaf digest),
    and m = sum(mix(w)) is a *nonlinear* mix column. The mix is what
    makes dirtiness detection sound against structured updates: a
    uniform shift of every word in a tile (e.g. float32 `x *= 2` bumps
    each exponent, adding 2^23 to every word — and 1024 * 2^23 ≡ 0 mod
    2^32) is invisible to any linear-in-words sum, but scatters under
    xor-shift-multiply. Equal rows between two snapshots mean the tile
    is clean (up to the 96-bit digest).

    Returns shape (n_tiles, 3) uint32; a trailing partial tile is
    zero-padded (harmless: padding contributes 0 to all three columns
    and the byte length is fixed by the leaf's dtype/shape).
    """
    b = byte_view(np.asarray(arr))
    nbytes = b.size
    nt = n_tiles(nbytes)
    if nt == 0:
        return np.zeros((0, 3), np.uint32)
    out = np.zeros((nt, 3), np.uint32)
    n_main = (nbytes // 4) * 4
    words = b[:n_main].view(np.uint32)
    full = words.size // TILE_WORDS
    if full:
        w = words[:full * TILE_WORDS].reshape(full, TILE_WORDS)
        out[:full, 0] = w.sum(axis=1, dtype=np.uint64) & M32
        out[:full, 1] = np.multiply(w, _TILE_ARANGE,
                                    dtype=np.uint32) \
            .sum(axis=1, dtype=np.uint64) & M32
        out[:full, 2] = _mix(w).sum(axis=1, dtype=np.uint64) & M32
    rest = words[full * TILE_WORDS:]
    tail = b[n_main:]
    if rest.size or tail.size:
        s0 = int(rest.sum(dtype=np.uint64)) & M32
        s1 = int(np.multiply(rest, _TILE_ARANGE[:rest.size],
                             dtype=np.uint32).sum(dtype=np.uint64)) & M32
        m = int(_mix(rest).sum(dtype=np.uint64)) & M32
        if tail.size:
            w_tail = int.from_bytes(tail.tobytes(), "little")
            s0 = (s0 + w_tail) & M32
            s1 = (s1 + (rest.size + 1) * w_tail) & M32
            m = (m + int(_mix(np.array([w_tail], np.uint32))[0])) & M32
        out[full, 0] = s0
        out[full, 1] = s1
        out[full, 2] = m
    return out


def gather_tiles_ref(arr: np.ndarray, idx) -> np.ndarray:
    """Gather the 4 KB tiles named by `idx` (ascending tile indices) from
    `arr`'s byte stream into one compact (len(idx), TILE_WORDS) uint32
    buffer, trailing partial tile zero-padded — the numpy oracle for the
    on-device dirty-tile gather (`ops.gather_tiles_device`)."""
    b = byte_view(np.asarray(arr))
    idx = np.asarray(idx, np.int64)
    nt = n_tiles(b.size)
    pad = nt * TILE_BYTES - b.size
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    tiles = b.view(np.uint32).reshape(nt, TILE_WORDS)
    return tiles[idx]


def scalar_from_tiles(tiles: np.ndarray) -> tuple[int, int]:
    """Fold per-tile digests into the whole-stream (s0, s1) pair (the mix
    column is dirtiness-only and does not participate).

    Tile t's local weights j+1 relate to global weights t*W + j + 1 by
        s1 = sum_t (s1_t + t*W * s0_t)    (mod 2^32)
    so the scalar digest costs nothing beyond the tiled pass. Bit-equal to
    `checksum_words_ref` on the same byte stream (asserted in tests).
    """
    t = np.asarray(tiles, dtype=np.uint64)
    if t.size == 0:
        return 0, 0
    s0 = int(t[:, 0].sum()) & M32
    base = (np.arange(t.shape[0], dtype=np.uint64) * TILE_WORDS) & M32
    s1 = int(((t[:, 1] + base * t[:, 0]) & M32).sum()) & M32
    return s0, s1
