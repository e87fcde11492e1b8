"""Device meshes over a torch.distributed process group (functions —
importing this module touches no process group or device).

One process drives one device. `process_group` starts the group and ends
it; `make_host_mesh` and `make_production_mesh` lay the group's ranks out
as a `DeviceMesh` with named axes. The device is explicit: `cuda` with
NCCL unless the caller names the CPU, which runs gloo.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.device import resolve


@contextlib.contextmanager
def process_group(world: int = 1, rank: int = 0, *, device=None,
                  init_method: Optional[str] = None):
    """Start this process's rank of a process group on `device` (`cuda`
    unless named: NCCL, the rank's card; `cpu`: gloo), yield, and end it.
    A group of one needs no `init_method`: its store listens on a port
    the OS picks, so groups in processes side by side never collide. A
    larger group needs one every rank names alike (`tcp://host:port`,
    `file://path`)."""
    import torch.distributed as dist
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {}
    if init_method is None:
        if world != 1:
            raise ValueError(f"a group of {world} ranks needs an init_method")
        kw["store"] = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    else:
        kw["init_method"] = init_method
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=rank, world_size=world, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, axes, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if n != have:
        raise RuntimeError(f"need {n} devices, have {have}")
    return init_device_mesh(resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 single-pod (256 devices) or 2×16×16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(shape=(1,), axes=("data",), *, device=None):
    """A mesh of `shape` over the initialised process group, whose world
    must be the mesh's size (one process a device)."""
    return _mesh(shape, axes, device)
