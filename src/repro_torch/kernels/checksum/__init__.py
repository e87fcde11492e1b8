"""The checksum kernels K1 (tile digests), K2 (whole-leaf digest) and K3
(dirty-tile gather), and their dispatch (`ops`).

Lazy exports (PEP 562): `ops` imports torch, but `_build` and `ref` do
not, so a torch-free process (the runtime's root) can build the kernel
library before it deploys workers.
"""
from repro_torch._lazy import lazy

_EXPORTS = {
    "checksum_words": ".ops",
    "leaf_checksum": ".ops",
    "tile_checksums": ".ops",
    "checksum_words_ref": ".ref",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy(__name__, globals(), _EXPORTS)
