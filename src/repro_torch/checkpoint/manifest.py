"""Pytree flattening, shard naming and integrity hashes for checkpoints.

States are nested dicts of arrays; leaves are addressed by their
"/"-joined key path, which makes the on-disk format self-describing and
re-shardable (a restore may run under a different process count than the
save — global-restart is non-shrinking but elastic re-hosting is not).

Integrity digests come in two algorithms:

  "wordsum"  (default) — the tiled-reduction checksum from
             `repro_torch.kernels.checksum`: CUDA tensors are digested
             *on device* by the hand-written kernel, CPU tensors by its
             plain torch version and host arrays by the vectorized numpy
             reference; no path materializes a `tobytes()` copy. Only the
             numpy dtype name, shape and two 4-byte word-sums feed the
             final (tiny) sha256, so digests match the JAX package's.
  "sha256"   — the legacy full-content hash, kept for the np.savez
             comparison path and old manifests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict

import numpy as np

from repro_torch.device import host_leaf
from repro_torch.kernels.checksum.ops import leaf_checksum

from .serde import _leaf_bytes, dtype_name


def flatten_state(state) -> Dict[str, Any]:
    """Nested-dict pytree -> {path: host leaf}. Lists become index keys.
    Tensors are copied to the host as numpy arrays (bfloat16, which numpy
    lacks, as a CPU tensor)."""
    return {k: host_leaf(v) for k, v in flatten_leaves(state).items()}


def flatten_leaves(state) -> Dict[str, Any]:
    """Like flatten_state but leaves untouched — tensors stay on their
    device (the fast checkpoint path digests and drains them itself)."""
    out: Dict[str, Any] = {}
    _flatten_into(out, "", state)
    return out


def _flatten_into(out: Dict[str, Any], prefix: str, node) -> None:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle holding `out`, so the leaves (device clones of a
    # snapshot) would outlive the caller until the cycle collector runs
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten_into(out, f"{prefix}/{k}" if prefix else str(k),
                          node[k])
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten_into(out, f"{prefix}/{i}", v)
    else:
        out[prefix] = node


def unflatten_state(flat: Dict[str, np.ndarray]):
    """Inverse of flatten_state (all containers restored as dicts; integer
    keys are restored as list entries when contiguous from 0)."""
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [fix(node[str(i)]) for i in idx]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def digest_from_checksum(dtype, shape, s0: int, s1: int) -> str:
    """Combine word-sums with leaf metadata into the digest string —
    only these few bytes ever reach hashlib. `dtype` is a numpy name
    (`dtype_name`), never a torch dtype."""
    h = hashlib.sha256()
    h.update(f"{dtype}|{tuple(shape)}".encode())
    h.update(s0.to_bytes(4, "little"))
    h.update(s1.to_bytes(4, "little"))
    return h.hexdigest()[:16]


def leaf_digest(arr) -> str:
    """Wordsum digest: on-device reduction for tensors, vectorized numpy
    for host arrays."""
    s0, s1 = leaf_checksum(arr)
    if not hasattr(arr, "dtype"):
        arr = np.asarray(arr)
    return digest_from_checksum(dtype_name(arr), tuple(arr.shape), s0, s1)


def leaf_digest_sha256(arr) -> str:
    """Legacy full-content digest (hashes a tobytes copy on the host)."""
    arr = host_leaf(arr)
    h = hashlib.sha256()
    h.update(dtype_name(arr).encode())
    h.update(str(tuple(arr.shape)).encode())
    h.update(_leaf_bytes(arr).tobytes())
    return h.hexdigest()[:16]


DIGESTS = {"wordsum": leaf_digest, "sha256": leaf_digest_sha256}


def tree_digest(state) -> str:
    """Order-stable digest of a whole state pytree."""
    flat = flatten_leaves(state)
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(leaf_digest(flat[k]).encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Manifest:
    step: int
    leaves: Dict[str, dict]          # path -> {shape, dtype, digest, shard}
    n_shards: int = 1
    extra: dict = dataclasses.field(default_factory=dict)
    algo: str = "wordsum"
    # delta checkpoints: "full" snapshots stand alone; a "delta" records
    # only dirty tile ranges against its parent step (chain walked at
    # load). Digests always describe the *composed* full state, so a
    # restore through any chain verifies end-to-end.
    kind: str = "full"
    base_step: int | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        d.setdefault("algo", "sha256")   # pre-wordsum manifests
        d.setdefault("kind", "full")     # pre-delta manifests
        d.setdefault("base_step", None)
        return cls(**d)

    @classmethod
    def build(cls, step: int, flat: Dict[str, Any], shard_of,
              n_shards: int, extra: dict | None = None,
              algo: str = "wordsum",
              digests: Dict[str, str] | None = None,
              kind: str = "full",
              base_step: int | None = None) -> "Manifest":
        """`digests` short-circuits hashing when the caller already
        computed them (e.g. on device, or in a per-shard thread pool)."""
        fn = DIGESTS[algo]

        def meta(k, v):
            if not hasattr(v, "shape"):
                v = np.asarray(v)
            return {"shape": list(v.shape), "dtype": dtype_name(v),
                    "digest": (digests[k] if digests is not None else fn(v)),
                    "shard": shard_of(k)}

        leaves = {k: meta(k, v) for k, v in flat.items()}
        return cls(step=step, leaves=leaves, n_shards=n_shards,
                   extra=extra or {}, algo=algo, kind=kind,
                   base_step=base_step)

    def verify(self, flat: Dict[str, Any], paths=None) -> list[str]:
        """Returns corrupted/missing leaf paths (empty = OK). With
        `paths`, checks only that subset (per-shard parallel verify) and
        skips the global missing-leaf sweep."""
        fn = DIGESTS[self.algo]
        bad = []
        keys = self.leaves.keys() if paths is None else paths
        for k in keys:
            meta = self.leaves.get(k)
            if meta is None or k not in flat:
                bad.append(k)
                continue
            if fn(flat[k]) != meta["digest"]:
                bad.append(k)
        return bad
