"""Training driver package (PyTorch).

Lazy exports (PEP 562): `trainer`/`data`/`optimizer` import torch, but
the process runtime's root imports only the stdlib-only `straggler`
module for gray-failure detection and must not pay for torch. Submodules
load on first attribute access; `from repro_torch.train import Trainer`
and `from repro_torch.train.straggler import ...` both keep working, the
latter without importing torch.
"""
from repro_torch._lazy import lazy

_EXPORTS = {
    "AdamWConfig": ".optimizer",
    "adamw_init": ".optimizer",
    "adamw_update": ".optimizer",
    "lr_at": ".optimizer",
    "TokenPipeline": ".data",
    "Trainer": ".trainer",
    "TrainConfig": ".trainer",
    "StragglerTracker": ".straggler",
}

__all__ = sorted(_EXPORTS)

__getattr__, __dir__ = lazy(__name__, globals(), _EXPORTS)
