"""Checkpoint package (PyTorch).

Lazy exports (PEP 562): `serde`, `manifest`, `file_ckpt` and
`memory_ckpt` import torch, but the simulator reads only the stdlib-only
`policy` module and must not pay for torch. Submodules load on first
attribute access; `from repro_torch.checkpoint import FileCheckpointer`
and `from repro_torch.checkpoint.policy import ...` both keep working,
the latter without importing torch.
"""
from repro_torch._lazy import lazy

_EXPORTS = {
    "serde": None,
    "Manifest": ".manifest",
    "flatten_leaves": ".manifest",
    "flatten_state": ".manifest",
    "tree_digest": ".manifest",
    "unflatten_state": ".manifest",
    "FileCheckpointer": ".file_ckpt",
    "BuddyStore": ".memory_ckpt",
    "buddy_exchange": ".memory_ckpt",
    "restore_from_buddy": ".memory_ckpt",
    "CheckpointPolicy": ".policy",
    "checkpoint_kind_for": ".policy",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy(__name__, globals(), _EXPORTS)
