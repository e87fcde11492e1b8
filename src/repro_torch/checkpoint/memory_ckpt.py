"""Buddy in-memory checkpointing.

Two faces of the same paper mechanism (local copy + copy on the cyclically
next rank):

1. `buddy_exchange` — the SPMD form: every shard of a mesh-distributed
   state (DTensor leaves placed by the sharding rules) moves one step
   along the data axis, so each rank's device holds its own shard *and*
   its left neighbour's. It is a ring of point-to-point sends over the
   mesh dim's process group (`batch_isend_irecv`): NCCL between cards,
   gloo on the CPU. Valid for single-shard failures (Table 2 of the
   paper): a lost rank's state is recovered from its right neighbour.

2. `BuddyStore` — the process-runtime form: a rank stores checkpoint bytes
   locally and pushes a copy to rank (r+1) % world. Re-spawned ranks pull
   their state back from the buddy. It handles frame bytes only, so it is
   the reference's threaded numpy code as it is.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

from repro_torch.device import is_dtensor
from repro_torch.tree import tree_map


def _ring(state, mesh, rules, axis: str, step: int):
    """Each leaf sharded on mesh axis `axis` with its shard moved `step`
    (+1 or -1) places around that axis's ring; other leaves as they are.
    Every leaf must be a DTensor placed as the rules place it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.sharding.partition import state_shardings

    dim = list(mesh.mesh_dim_names).index(axis)
    n = mesh.size(dim)
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)

    def move(leaf, sharding):
        want = sharding.placements
        if not is_dtensor(leaf) or tuple(leaf.placements) != want:
            got = leaf.placements if is_dtensor(leaf) else "a plain tensor"
            raise ValueError(f"a state leaf placed as {got}, not as the "
                             f"rules place it ({want})")
        if not isinstance(want[dim], Shard):
            return leaf              # replicated over the axis: redundant
        local = leaf.to_local().contiguous()
        recv = torch.empty_like(local)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, local, to),
                                         dist.P2POp(dist.irecv, recv, frm)]):
            w.wait()
        return DTensor.from_local(recv, mesh, want, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return tree_map(move, state, state_shardings(mesh, state, rules))


def buddy_exchange(state, mesh, rules, axis: str = "data"):
    """Returns the buddy copy of `state`: each data-shard moved one step
    (cyclically, rank r's shard to rank r+1) along `axis`. Leaves not
    sharded on `axis` come back unchanged (they are already replicated =
    already redundant); on an axis of one the state comes back as it
    is. Every rank of the mesh calls it."""
    if mesh.size(list(mesh.mesh_dim_names).index(axis)) == 1:
        return state
    return _ring(state, mesh, rules, axis, +1)


def restore_from_buddy(buddy_state, mesh, rules, axis: str = "data"):
    """Inverse shift (rank r+1's copy back to rank r): rebuild the
    original state from buddy copies. After a shard loss, the survivor
    copies plus the buddy ring reconstruct every shard (single-failure
    guarantee, as in the paper)."""
    if mesh.size(list(mesh.mesh_dim_names).index(axis)) == 1:
        return buddy_state
    return _ring(buddy_state, mesh, rules, axis, -1)


class _Spilled:
    """Marker for a payload tiered out to local disk. `owned` entries
    were written by the store (deleted on eviction); un-owned entries
    reference a file some other layer already persisted (e.g. the
    worker's rank checkpoint file) — the tier must neither rewrite nor
    delete those."""

    __slots__ = ("path", "nbytes", "kind", "owned")

    def __init__(self, path: str, nbytes: int, kind: str,
                 owned: bool = True):
        self.path = path
        self.nbytes = nbytes
        self.kind = kind
        self.owned = owned


class BuddyStore:
    """Rank-local in-memory checkpoint store with a remote buddy copy and
    an optional spill-to-file tier.

    `push_remote` is injected by the runtime (worker TCP send); the store
    itself is transport-agnostic so the trainer and tests can use it with a
    plain dict fabric.

    Tiering (the paper's memory/file dichotomy promoted to an LRU tier):
    with `spill_dir` set, only the `hot_steps` newest steps of each
    retention window stay resident; older retained payloads are written
    out as frame files on local disk and read back transparently on
    access. Spilled serde *base* frames are additionally kept alive past
    the retention window while a retained delta frame still chains to
    them, so every retained step stays composable.
    """

    def __init__(self, rank: int, world: int,
                 push_remote: Optional[Callable[[int, int, bytes], None]] = None,
                 *, retain: int = 2, spill_dir: Optional[str] = None,
                 hot_steps: Optional[int] = None):
        self.rank = rank
        self.world = world
        self.push_remote = push_remote
        # retention window: keep steps in [latest - retain, latest], both
        # locally and for held buddy copies — retain+1 checkpoints total,
        # enough for the BSP skew of one step plus the rejoin consensus
        self.retain = retain
        self.spill_dir = spill_dir
        self.hot_steps = retain + 1 if hot_steps is None else max(1,
                                                                  hot_steps)
        self.spilled_bytes = 0      # guarded-by: _lock (bytes spilled)
        self._lock = threading.Lock()
        self.local: Dict[int, Any] = {}       # guarded-by: _lock
        self._local_disk: Dict[int, str] = {}   # guarded-by: _lock
        self.held: Dict[int, Dict[int, Any]] = {}   # guarded-by: _lock
        # ring membership: None = the dense 0..world-1 ring; a shrinking
        # recovery re-forms it over the (possibly non-contiguous)
        # surviving rank ids
        self._members: Optional[list] = None    # guarded-by: _lock

    @property
    def buddy(self) -> int:
        with self._lock:
            if self._members is None:
                return (self.rank + 1) % self.world
            i = self._members.index(self.rank)
            return self._members[(i + 1) % len(self._members)]

    def reform_ring(self, members) -> None:
        """Re-form the buddy ring over `members` (sorted surviving rank
        ids) after an elastic shrink: the buddy becomes the next surviving
        rank. Held frames for dropped origins are no longer needed but
        are left to age out of the retention window."""
        ms = sorted(members)
        if self.rank not in ms:
            return      # stale broadcast to a rank outside the new world;
                        # its process is about to be reaped anyway
        with self._lock:
            self._members = ms
            self.world = len(ms)

    # ----------------------------------------------------------- tiering

    def _payload_kind(self, payload: bytes) -> str:
        from . import serde
        return serde.peek_kind(payload)

    def _spill_path(self, tag: str, step: int) -> str:
        return os.path.join(self.spill_dir, f"{tag}.s{step}.bin")

    def _prune(self, d: Dict[int, Any], latest: int, tag: str,
               disk_refs: Dict[int, str] | None = None) -> list:  # holds-lock: _lock
        """Window policy for one {step: payload} map (caller holds the
        lock). Keeps [latest - retain, latest]; when the window floor is
        a delta frame its chain is walked down to the full-frame anchor
        so every kept step stays composable. Cold entries with a known
        on-disk copy (`disk_refs`) become zero-I/O reference markers;
        the rest are returned as the spill worklist [(step, payload,
        path)] — those file writes happen *outside* the lock (see
        _spill) so concurrent hold()/held_map() never stall on disk
        I/O."""
        lo = latest - self.retain
        keep = {s for s in d if s >= lo}
        if keep:
            # delta frames chain to step-1: walk the window floor's chain
            # down to its full-frame anchor so every kept step composes
            kinds = {s: (e.kind if isinstance(e, _Spilled)
                         else self._payload_kind(e)) for s, e in d.items()}
            s = min(keep)
            while kinds.get(s) == "delta" and (s - 1) in d:
                s -= 1
                keep.add(s)
        for s in [s for s in d if s not in keep]:
            e = d.pop(s)
            if isinstance(e, _Spilled):
                if e.owned:
                    self.spilled_bytes -= e.nbytes
                    try:
                        os.unlink(e.path)
                    except OSError:
                        pass
        if self.spill_dir is None:
            return []
        hot_floor = latest - (self.hot_steps - 1)
        work = []
        for s, e in list(d.items()):
            if s >= hot_floor or isinstance(e, _Spilled):
                continue
            ref = (disk_refs or {}).get(s)
            if ref is not None:     # durable copy exists: just point at it
                d[s] = _Spilled(ref, len(e), self._payload_kind(e),
                                owned=False)
            else:
                work.append((s, e, self._spill_path(tag, s)))
        return work

    def _spill(self, d: Dict[int, Any], work: list):
        """Write the spill worklist to disk lock-free (payload bytes are
        immutable), then swap in the markers under the lock; an entry
        evicted meanwhile just has its fresh file deleted."""
        for s, payload, path in work:
            os.makedirs(self.spill_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
            with self._lock:
                if d.get(s) is payload:
                    d[s] = _Spilled(path, len(payload),
                                    self._payload_kind(payload))
                    self.spilled_bytes += len(payload)
                    continue
            try:
                os.unlink(path)             # superseded while we wrote
            except OSError:
                pass

    def _fetch(self, e) -> bytes:
        if isinstance(e, _Spilled):
            with open(e.path, "rb") as f:
                return f.read()
        return e

    def resident_bytes(self) -> int:
        with self._lock:
            maps = [self.local] + list(self.held.values())
            return sum(len(e) for m in maps for e in m.values()
                       if not isinstance(e, _Spilled))

    # ------------------------------------------------------------- store

    def save(self, step: int, payload: bytes,
             on_disk: Optional[str] = None):
        """`on_disk`: path of a durable copy of `payload` some other
        layer already wrote (e.g. the rank's file checkpoint) — the
        spill tier then references it instead of writing a duplicate."""
        with self._lock:
            d = self.local
            d[step] = payload
            if on_disk is not None:
                self._local_disk[step] = on_disk
            work = self._prune(d, step, "local", self._local_disk)
            for s in [s for s in self._local_disk if s not in d]:
                del self._local_disk[s]
        self._spill(d, work)
        if self.push_remote is not None:
            self.push_remote(self.buddy, step, payload)

    def hold(self, origin_rank: int, step: int, payload: bytes):
        """Called when a buddy pushes its checkpoint to us."""
        with self._lock:
            d = self.held.setdefault(origin_rank, {})
            d[step] = payload
            work = self._prune(d, step, f"held_{origin_rank}")
        self._spill(d, work)

    def _fetch_map(self, snap: Dict[int, Any]) -> Dict[int, bytes]:
        """Materialize a snapshot of entries *outside* the lock (disk
        reads don't stall concurrent save/hold); an entry whose backing
        file was reaped underneath us is simply dropped — it was out of
        the window anyway."""
        out = {}
        for s, e in snap.items():
            try:
                out[s] = self._fetch(e)
            except OSError:
                pass
        return out

    def latest_local(self):
        m = self.local_map()
        if not m:
            return None, None
        s = max(m)
        return s, m[s]

    def latest_held(self, origin_rank: int):
        m = self.held_map(origin_rank)
        if not m:
            return None, None
        s = max(m)
        return s, m[s]

    def local_map(self) -> Dict[int, bytes]:
        with self._lock:
            snap = dict(self.local)
        return self._fetch_map(snap)

    def held_map(self, origin_rank: int) -> Dict[int, bytes]:
        with self._lock:
            snap = dict(self.held.get(origin_rank, {}))
        return self._fetch_map(snap)
