"""Device selection: the port runs on the CUDA card unless told otherwise.

`resolve()` gives `cuda` by default and raises when no card is present;
the CPU is used only when the caller names it (`device="cpu"`, as the
tests do, or `--device cpu` on the command line).

`set_deterministic()` is the global torch state the entry points set
before they build anything: deterministic algorithms (so a recovered run
is bit-identical to a fault-free one on the card), cuBLAS's fixed
workspace, and no TF32 in float32 matmuls or convolutions. Importing this
module sets nothing.
"""
from __future__ import annotations

import os

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: `cuda` unless `device` names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev


def set_deterministic() -> None:
    """Global settings for bit-reproducible training. Must run before
    CUDA is initialised: cuBLAS reads its workspace setting then."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # deterministic mode would also fill every new tensor with NaN before
    # use (an extra write of every output); nothing here reads memory it
    # did not write, so skip that
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
