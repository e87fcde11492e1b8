from .ops import checksum_words, leaf_checksum, tile_checksums
from .ref import checksum_words_ref

__all__ = ["checksum_words", "checksum_words_ref", "leaf_checksum",
           "tile_checksums"]
