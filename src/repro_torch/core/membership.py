"""Cluster membership as a first-class, bidirectional state machine.

Before this module the membership/epoch bookkeeping was smeared across
the root (a `world_ranks` set mutated by three recovery paths), the
worker (its own `world_ranks` list adopted from broadcasts) and the
`ElasticManager` (spare-pool consultation only, one-way: a shrunk world
could never grow back).  `MembershipMachine` centralizes all of it:

    states       the current world (rank-id set), the spare pool, the
                 ranks currently *dropped* out of the world, and the
                 mesh epoch that keys compiled-step caches
    transitions  node_loss / rank_loss  -> respawn | shrink
                 rejoin (repaired node) -> grow | spare_grant
    invariants   floor <= |world| <= |initial world|
                 mesh epoch strictly monotonic across re-meshing
                 world == initial - dropped (shrink/grow round-trips
                 restore exactly the pre-shrink cut)

The same machine drives the real root (`--mode shrink`), the in-process
trainer and the discrete-event simulator, so the property tests in
`tests/test_membership.py` state the protocol invariants once and every
substrate inherits them.

Worker-side, `RankMembership` is the rank's adopted view of the same
state: world membership + recovery epoch, updated only through the
root's broadcasts (RANK_TABLE / SHRINK / GROW), never locally invented.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .events import FailureEvent, FailureType, GrowCommand, PromoteCommand, \
    ReinitCommand, ShrinkCommand
from .protocol import ClusterView, root_handle_failure, \
    root_handle_failure_promote, root_handle_failure_shrink, \
    root_handle_rejoin


@dataclasses.dataclass
class MeshEpoch:
    """One incarnation of the device mesh. The epoch is the compiled-step
    cache key: recovery that re-forms the mesh bumps the epoch, anything
    that keeps it (Reinit++ process recovery) reuses compiled artifacts."""
    epoch: int
    data_parallel: int
    model_parallel: int
    pods: int = 1

    @property
    def n_shards(self) -> int:
        return self.pods * self.data_parallel * self.model_parallel


@dataclasses.dataclass(frozen=True)
class Transition:
    """One audited membership transition (the machine's history log)."""
    kind: str        # respawn | shrink | grow | spare | shadow |
                     # shadow_lost | promote
    trigger: str                     # node_loss | rank_loss | rejoin
    epoch: int                       # cluster-view epoch after
    mesh_epoch: int                  # mesh epoch after
    world: tuple                     # rank ids after
    dropped: tuple = ()              # ranks leaving the world (shrink)
    added: tuple = ()                # ranks re-admitted (grow)


class MembershipMachine:
    """Root-side membership + mesh-epoch state machine (see module doc).

    `decide` is pure policy; `respawn`/`shrink`/`grow`/`grant_spare`
    execute a transition (mutating the ClusterView through the protocol
    functions, which the simulator and runtime share) and append it to
    the audit log. `check_invariants` is called after every transition
    and is what the property suite hammers."""

    def __init__(self, view: ClusterView, mesh: MeshEpoch, *,
                 min_data_parallel: int = 1,
                 ranks_per_node: Optional[int] = None):
        self.view = view
        self.mesh = mesh
        self.min_data_parallel = min_data_parallel
        # group width used by the world-size floor and by grow capacity;
        # the root builds the mesh with model_parallel == ranks-per-node
        self.ranks_per_node = ranks_per_node if ranks_per_node is not None \
            else mesh.model_parallel
        self.initial_world: tuple = tuple(sorted(view.ranks()))
        # rank groups currently outside the world, in drop order. Each
        # entry is (home_node, ranks): one shrink = one group = one
        # consistent cut, so a grow re-admits whole groups — its own
        # node's group when that node rejoins, else the most recently
        # dropped one (whose cut the survivors still hold pinned).
        # home_node is None for process-level drops (their node lives).
        self._drop_groups: List[tuple] = []
        # pre-admitted warm members: rank -> daemon hosting its shadow.
        # Shadows are *outside* the world (they hold state, not a rank
        # id) until a promote transition swaps them in.
        self._shadows: dict = {}
        self.log: List[Transition] = []

    @property
    def dropped(self) -> List[int]:
        """Ranks currently outside the world, in drop order."""
        return [r for _, ranks in self._drop_groups for r in ranks]

    # ----------------------------------------------------------- queries

    @property
    def floor_world(self) -> int:
        """Smallest legal world: `min_data_parallel` whole groups."""
        return self.min_data_parallel * self.ranks_per_node

    def world(self) -> tuple:
        return tuple(self.view.ranks())

    def spares(self) -> list:
        return self.view.spares()

    def _lost_count(self, failure: FailureEvent) -> int:
        if failure.kind is FailureType.NODE:
            return len(self.view.children.get(failure.node, ()))
        return 1

    # ------------------------------------------------------------ policy

    def decide(self, failure: FailureEvent) -> str:
        """The spare-pool consultation of §3.2, extended past the paper:

          "respawn"  a spare slot (or a surviving host) can absorb the
                     loss — global-restart recovery re-hosts the failed
                     ranks (Algorithm 1);
          "shrink"   the spare pool is exhausted and the world can still
                     legally contract — the lost ranks (a whole node's,
                     or a single rank's, leaving uneven groups) are
                     dropped and survivors re-balance.

        Falls back to "respawn" (over-subscription / in-place respawn)
        when shrinking would cross the `min_data_parallel` world floor."""
        if self.spares():
            return "respawn"
        lost = self._lost_count(failure)
        if len(self.world()) - lost >= self.floor_world and lost > 0:
            return "shrink"
        return "respawn"

    def admit(self, node: str) -> str:
        """Root-side admission policy for a REJOIN: a repaired node grows
        the world back while ranks are missing from it, and otherwise
        joins the spare pool."""
        return "grow" if self.dropped else "spare"

    @property
    def shadows(self) -> dict:
        """rank -> daemon hosting that rank's warm shadow (read-only)."""
        return dict(self._shadows)

    def can_promote(self, failure: FailureEvent) -> bool:
        """True iff every rank lost by `failure` has a warm shadow — the
        precondition of the zero-rollback path. A rank without one falls
        back to decide() (respawn/shrink)."""
        if failure.kind is FailureType.NODE:
            lost = self.view.children.get(failure.node, set())
            return bool(lost) and all(
                self._shadows.get(r) not in (None, failure.node)
                for r in lost)
        return failure.rank in self._shadows

    # ------------------------------------------------------- transitions

    def respawn(self, failure: FailureEvent) -> ReinitCommand:
        """Global-restart (paper): same world, failed ranks re-hosted.
        Mesh epoch only bumps for node failures (device set changed)."""
        cmd = root_handle_failure(self.view, failure)
        if failure.kind is FailureType.NODE:
            self.mesh = dataclasses.replace(self.mesh,
                                            epoch=self.mesh.epoch + 1)
        trigger = "node_loss" if failure.kind is FailureType.NODE \
            else "rank_loss"
        self._record("respawn", trigger)
        return cmd

    def shrink(self, failure: FailureEvent) -> ShrinkCommand:
        """Contract the world by the lost ranks (node group or single
        rank — the latter leaves uneven rank-per-node groups). Always
        bumps the mesh epoch: the logical world changed, compiled steps
        keyed on the old shape are invalid."""
        lost = self._lost_count(failure)
        assert len(self.world()) - lost >= self.floor_world, \
            f"shrink below floor {self.floor_world}"
        cmd = root_handle_failure_shrink(self.view, failure)
        dp = self.mesh.data_parallel
        # dp tracks whole data-parallel groups, symmetrically with
        # grow(): only a full node group moves it — partial groups
        # (uneven worlds) leave it conservative
        if failure.kind is FailureType.NODE and dp > 1 \
                and len(cmd.dropped) == self.ranks_per_node:
            dp -= 1
        self.mesh = dataclasses.replace(self.mesh,
                                        epoch=self.mesh.epoch + 1,
                                        data_parallel=dp)
        home = failure.node if failure.kind is FailureType.NODE else None
        self._drop_groups.append((home, tuple(sorted(cmd.dropped))))
        trigger = "node_loss" if failure.kind is FailureType.NODE \
            else "rank_loss"
        self._record("shrink", trigger, dropped=cmd.dropped)
        return cmd

    def grow(self, node: str) -> GrowCommand:
        """Re-admit one dropped group onto a repaired node (REJOIN ->
        GROW): the rejoined node's own group when it is among the drops,
        else the most recently dropped one — in both cases a group whose
        consistent cut the survivors still hold pinned, so the grow
        consensus lands exactly back on it. Never mixes ranks from
        different shrinks (different cuts) into one grow. Bumps the mesh
        epoch; restores a data-parallel degree when a full node group
        returns."""
        assert self._drop_groups, \
            "grow with no dropped ranks (use grant_spare)"
        idx = next((i for i in range(len(self._drop_groups) - 1, -1, -1)
                    if self._drop_groups[i][0] == node),
                   len(self._drop_groups) - 1)
        _, added = self._drop_groups.pop(idx)
        cmd = root_handle_rejoin(self.view, node, added)
        dp = self.mesh.data_parallel
        if len(added) == self.ranks_per_node:
            dp += 1
        self.mesh = dataclasses.replace(self.mesh,
                                        epoch=self.mesh.epoch + 1,
                                        data_parallel=dp)
        cmd = dataclasses.replace(cmd, mesh_epoch=self.mesh.epoch)
        self._record("grow", "rejoin", added=added)
        return cmd

    def admit_shadow(self, rank: int, node: str):
        """Pre-admit a warm shadow for `rank`, hosted on `node` (normally
        a spare). Shadows are warm state outside the world: no epoch or
        mesh change — membership is untouched until a promote."""
        assert rank in self.world(), f"shadow for unknown rank {rank}"
        assert node in self.view.children, f"shadow on unknown node {node}"
        assert node != self.view.parent(rank), \
            f"shadow for rank {rank} co-hosted with its primary"
        self._shadows[rank] = node
        self._record("shadow", "admit", added=(rank,))

    def shadow_lost(self, rank: int):
        """A shadow died (or its host did): the rank loses replica
        protection and future failures fall back to decide()."""
        if self._shadows.pop(rank, None) is not None:
            self._record("shadow_lost", "shadow_loss", dropped=(rank,))

    def promote(self, failure: FailureEvent) -> PromoteCommand:
        """Zero-rollback failover: the failed ranks' warm shadows take
        over their rank ids in place. The world's rank set and the mesh
        shape are unchanged, so the mesh epoch does NOT bump — compiled
        steps everywhere stay valid. Consumes the shadows."""
        assert self.can_promote(failure), f"no warm shadow for {failure}"
        cmd = root_handle_failure_promote(self.view, failure, self._shadows)
        for p in cmd.promotions:
            self._shadows.pop(p.rank, None)
        # a dead node also takes down any shadows it hosted
        if failure.kind is FailureType.NODE:
            for r, host in list(self._shadows.items()):
                if host == failure.node:
                    self._shadows.pop(r)
        trigger = "node_loss" if failure.kind is FailureType.NODE \
            else "rank_loss"
        self._record("promote", trigger,
                     added=tuple(p.rank for p in cmd.promotions))
        return cmd

    def grant_spare(self, node: str):
        """A repaired node rejoins a full world: it becomes an (empty)
        over-provisioned spare. No epoch or mesh change — nothing about
        the running world moved."""
        self.view.children.setdefault(node, set())
        self._record("spare", "rejoin")

    # --------------------------------------------------------- integrity

    def _record(self, kind: str, trigger: str, *, dropped=(), added=()):
        self.log.append(Transition(
            kind=kind, trigger=trigger, epoch=self.view.epoch,
            mesh_epoch=self.mesh.epoch, world=self.world(),
            dropped=tuple(dropped), added=tuple(added)))
        self.check_invariants()

    def check_invariants(self):
        world = set(self.world())
        assert self.floor_world <= len(world) <= len(self.initial_world), \
            (sorted(world), self.floor_world, self.initial_world)
        assert world == set(self.initial_world) - set(self.dropped), \
            "world diverged from initial - dropped"
        assert world.isdisjoint(self.dropped)
        mesh_epochs = [t.mesh_epoch for t in self.log]
        assert all(a <= b for a, b in zip(mesh_epochs, mesh_epochs[1:])), \
            "mesh epoch went backwards"
        remesh = [t.mesh_epoch for t in self.log
                  if t.kind in ("shrink", "grow")
                  or (t.kind == "respawn" and t.trigger == "node_loss")]
        assert all(a < b for a, b in zip(remesh, remesh[1:])), \
            "re-meshing transition without a strict mesh-epoch bump"
        # a promote is in-place: the rank set and the mesh shape are
        # untouched, so its mesh epoch must equal its predecessor's
        for i, t in enumerate(self.log):
            if t.kind == "promote" and i > 0:
                prev = self.log[i - 1]
                assert t.mesh_epoch == prev.mesh_epoch, \
                    "promote bumped the mesh epoch"
                assert set(t.world) == set(prev.world), \
                    "promote changed the rank set"
        # shadows never alias live hosting: a rank's shadow lives on a
        # different daemon than the rank itself
        for r, host in self._shadows.items():
            if r in world:
                assert self.view.parent(r) != host, \
                    f"rank {r} shadowed on its own host {host}"


@dataclasses.dataclass
class RankMembership:
    """One rank's adopted view of the membership (worker side).

    The worker never invents membership: this object only changes when a
    root broadcast (RANK_TABLE carrying the world, SHRINK, GROW) says
    so, and the recovery epoch is what unblocks stale barrier waits."""
    rank: int
    world_ranks: List[int]
    epoch: int
    initial_world: int

    @property
    def size(self) -> int:
        return len(self.world_ranks)

    @property
    def shrunk(self) -> bool:
        """True while ranks are missing — the worker keeps its consistent
        cut pinned on disk as the grow-back anchor exactly while this
        holds."""
        return self.size < self.initial_world

    def adopt(self, world=None, epoch: Optional[int] = None):
        if world is not None:
            self.world_ranks = [int(r) for r in world]
        if epoch is not None:
            self.epoch = int(epoch)
