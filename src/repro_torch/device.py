"""Device selection: the port runs on the CUDA card unless told otherwise.

`resolve()` gives `cuda` by default and raises when no card is present;
the CPU is used only when the caller names it (`device="cpu"`, as the
tests do, or `--device cpu` on the command line).

`set_deterministic()` is the global torch state the entry points set
before they build anything: deterministic algorithms (so a recovered run
is bit-identical to a fault-free one on the card), cuBLAS's fixed
workspace, and no TF32 in float32 matmuls or convolutions. Importing this
module sets nothing.

Moving leaves between host and device: `to_device` places a host leaf
(numpy, bfloat16 bits kept, or a CPU tensor) on a device as a tensor of
its own; `host_leaf` brings a leaf back; `HostCopy` starts a device
leaf's copy into pinned host memory without waiting for it.

`is_dtensor` tells a mesh-distributed tensor from a plain one without
importing torch.distributed.tensor for a plain one; `require_local` is
how a kernel wrapper refuses a DTensor (its pointer is one shard's, its
shape the whole tensor's).
"""
from __future__ import annotations

import os

import numpy as np
import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: `cuda` unless `device` names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev


def is_dtensor(t) -> bool:
    """Whether `t` is a DTensor (a tensor distributed over a mesh)."""
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def require_local(what: str, *ts) -> None:
    """TypeError if any of `ts` is a DTensor: `what` launches a kernel on
    a tensor's pointer and element count, which for a DTensor are one
    shard's and the whole tensor's."""
    if any(is_dtensor(t) for t in ts):
        raise TypeError(
            f"{what} takes plain tensors; a DTensor reaches a kernel only "
            f"through sharding.partition.local_call, one shard at a time")


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


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host leaf (numpy, whose bfloat16 from ml_dtypes keeps its bits,
    or a tensor) -> a tensor of its own on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def host_leaf(v):
    """A leaf on the host: numpy, or a CPU tensor for bfloat16."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


class HostCopy:
    """A CUDA tensor's copy into pinned host memory, started with
    non_blocking=True on the current stream and recorded by an event;
    `result()` waits for the event and returns the host leaf."""

    __slots__ = ("host", "event")

    def __init__(self, dev: torch.Tensor):
        self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        self.host.copy_(dev, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def result(self):
        self.event.synchronize()
        return host_leaf(self.host)
