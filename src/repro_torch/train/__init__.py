"""Training driver package (PyTorch)."""
from .data import TokenPipeline
from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_at
from .straggler import StragglerTracker
from .trainer import TrainConfig, Trainer

__all__ = ["AdamWConfig", "StragglerTracker", "TokenPipeline", "TrainConfig",
           "Trainer", "adamw_init", "adamw_update", "lr_at"]
