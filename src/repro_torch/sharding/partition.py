"""Applying sharding rules: DTensor placements for states, the
constraint scope, and calls on each rank's own shards.

A spec becomes DTensor placements on a `DeviceMesh` in one place,
`placements`: a mesh axis on tensor dim d is `Shard(d)` on that mesh dim,
a tuple of axes is `Shard(d)` on each of them (major to minor, which must
be the mesh's own order), and every mesh dim no entry names is
`Replicate()`. `_divisible` runs first wherever a placement is made from
a tensor's shape: DTensor would pad an uneven shard, the reference drops
the axis (56 heads on a 16-way axis replicate), and the buddy ring moves
equal shards only.

`constraint_scope(mesh, rules)` arms `shard_constraint` so model code can
annotate intermediates with *logical* axes; outside a scope the
annotation is the identity, which keeps single-device runs mesh-free.
Inside, it redistributes a DTensor, and a plain tensor raises: it is an
input that was never distributed. The scope also treats plain tensors
that model code makes (positions, masks, accumulators) as replicated.

DTensor is imported when a mesh is used, never when this module is.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import is_dtensor
from repro_torch.tree import tree_map

from .rules import P, PartitionSpec, ShardingRules, tree_specs

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx", default=None)


def _axis_size(mesh, axis) -> int:
    """The size of a mesh axis by name, or of a tuple of axes."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@contextlib.contextmanager
def constraint_scope(mesh, rules: ShardingRules):
    """Arm `shard_constraint` (and `local_call`) with `mesh` and `rules`,
    and treat plain tensors met by DTensor ops as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    tok = _CTX.set((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.reset(tok)


def _divisible(spec: P, shape, mesh) -> P:
    """Drop mesh axes that do not divide the corresponding dim evenly."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        out.append(ax if dim % _axis_size(mesh, ax) == 0 else None)
    return P(*out)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} split dim {d} in another order "
                             f"than the mesh's {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} named twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each shard of a leaf lives."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def shard_constraint(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Redistribute x to the rules' layout of `logical_axes` (axes that do
    not divide x's dims dropped); the identity outside a scope."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not is_dtensor(x):
        raise TypeError(
            f"shard_constraint{logical_axes} met a plain tensor of shape "
            f"{tuple(x.shape)} inside a constraint scope: an input of the "
            f"step was never distributed")
    spec = _divisible(rules.spec(*logical_axes), x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def state_shardings(mesh, state, rules: ShardingRules):
    """NamedSharding tree for a full train/serve state tree, each spec
    fitted to its leaf by `_divisible` (what keeps odd head counts legal:
    the rule is applied where it divides and dropped where it doesn't)."""
    specs = tree_specs(state, rules)
    return tree_map(
        lambda s, leaf: NamedSharding(mesh, _divisible(
            s, getattr(leaf, "shape", ()), mesh)), specs, state)


def tree_shardings(mesh, params, rules: ShardingRules):
    """NamedSharding tree for a parameter tree. Unlike the reference's
    (whose JAX arrays may be split unevenly), each spec is fitted to its
    leaf by `_divisible`: a DTensor placement here is never uneven."""
    return state_shardings(mesh, params, rules)


def batch_spec(rules: ShardingRules, *, seq_axis: bool = False) -> P:
    """(B, S) token batches: batch over DP axes, optionally seq-parallel."""
    return P(rules.batch, rules.seq if seq_axis else None)


# ------------------------------------------------------ placing and local

def _shard_extent(mesh, pl, shape) -> tuple[list, list]:
    """(offset, size) per tensor dim of this rank's shard under
    placements `pl`: shards are even (`_divisible`), and a dim split over
    several mesh dims is split major to minor in mesh order."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    off, size = [0] * len(shape), list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(i)
            off[p.dim] += coord[i] * size[p.dim]
    return off, size


def local_offsets(t) -> tuple:
    """The global index of the first element of a DTensor's local shard,
    per tensor dim (zeros for a plain tensor)."""
    if not is_dtensor(t):
        return (0,) * t.dim()
    return tuple(_shard_extent(t.device_mesh, t.placements, t.shape)[0])


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """A DTensor placed by `sharding` from `t`, the same full tensor on
    every rank: each rank keeps a copy of its own slice, with no
    communication (a leaf that is not split, as every leaf on a mesh of
    one device, keeps `t` itself)."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    if tuple(_divisible(spec, t.shape, mesh)) != \
            spec + (None,) * (t.dim() - len(spec)):
        raise ValueError(f"{sharding.spec} does not divide a leaf of shape "
                         f"{tuple(t.shape)}")
    return from_full(t, mesh, sharding.placements)


def from_full(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """`distribute` by DTensor placements `pl` (even shards)."""
    from torch.distributed.tensor import DTensor
    local = t
    for d, (o, n) in enumerate(zip(*_shard_extent(mesh, pl, t.shape))):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    if local is not t:
        local = local.clone()        # t's storage is not kept alive
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, shardings):
    """`distribute` leafwise: a tree of tensors and a NamedSharding tree
    shaped like it."""
    return tree_map(distribute, tree, shardings)


def gather(t):
    """A DTensor's full value as a plain tensor on every rank (a
    collective: every rank of the mesh calls it); a plain tensor as it
    is."""
    return t.full_tensor() if is_dtensor(t) else t


def gather_tree(tree):
    return tree_map(gather, tree)


def barrier(mesh) -> None:
    """Wait for every rank of `mesh` (a mesh over the whole group, as
    `launch.mesh` builds them)."""
    import torch.distributed as dist
    if mesh.device_type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def local_call(fn: Callable, args: tuple, in_axes: tuple, outs: tuple):
    """`fn` on each rank's own shards of the DTensor `args`, through
    `torch.distributed.tensor.experimental.local_map`, inside the current
    constraint scope. Each arg is first laid out by its logical axes
    (`in_axes`, one tuple per arg); `outs` gives, per output of fn, its
    logical axes and global shape. Only a function whose result on a
    shard is that shard of its result on the whole (attention per lane
    and head, a scan per lane and channel) may be called so. fn gets the
    local tensors and `specs=` the args' fitted specs, `coord=` a dict of
    mesh axis name -> (this rank's index, axis size). A plain tensor arg
    is taken as replicated, as the scope takes it."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    ctx = _CTX.get()
    if ctx is None:
        raise RuntimeError("local_call needs a constraint scope")
    mesh, rules = ctx
    args = tuple(a if is_dtensor(a) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args)
    specs = [_divisible(rules.spec(*ax), a.shape, mesh)
             for a, ax in zip(args, in_axes)]
    # local_map reads a list as one output's placements, a tuple as one
    # entry per output
    out_pl = tuple(list(placements(_divisible(rules.spec(*ax), shape, mesh),
                                   mesh)) for ax, shape in outs)
    coord = {n: (c, mesh.size(i)) for i, (n, c) in enumerate(
        zip(mesh.mesh_dim_names, mesh.get_coordinate()))}
    mapped = local_map(
        lambda *xs: fn(*xs, specs=specs, coord=coord),
        out_placements=out_pl,
        in_placements=tuple(list(placements(s, mesh)) for s in specs),
        redistribute_inputs=True, device_mesh=mesh)
    return mapped(*args)
