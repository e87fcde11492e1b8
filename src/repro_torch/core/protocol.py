"""Algorithms 1 and 2 of the paper as pure, testable logic.

The same functions drive all three substrates: the real-process runtime
(repro.runtime), the fault-tolerant trainers (repro.train.trainer,
repro_torch.train.trainer) and the
discrete-event simulator (repro.sim.cluster). Keeping them pure — cluster
view in, decision out — is what lets the property tests state protocol
invariants directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Set

from .events import (FailureEvent, FailureType, GrowCommand, PromoteCommand,
                     Promotion, RankState, ReinitCommand, Respawn,
                     ShrinkCommand)


@dataclasses.dataclass
class ClusterView:
    """Root's model of the deployment tree (paper Fig. 3)."""
    children: Dict[str, Set[int]]            # daemon -> child ranks
    epoch: int = 0

    @classmethod
    def build(cls, n_nodes: int, ranks_per_node: int,
              spare_nodes: int = 0) -> "ClusterView":
        """Standard deployment: `n_nodes` full nodes plus `spare_nodes`
        empty over-provisioned nodes (for node-failure recovery)."""
        children = {
            f"node{n}": set(range(n * ranks_per_node,
                                  (n + 1) * ranks_per_node))
            for n in range(n_nodes)
        }
        for s in range(spare_nodes):
            children[f"spare{s}"] = set()
        return cls(children=children)

    # ------------------------------------------------------------ queries

    def parent(self, rank: int) -> str:
        for d, cs in self.children.items():
            if rank in cs:
                return d
        raise KeyError(f"rank {rank} not in any daemon")

    def daemons(self) -> list[str]:
        return sorted(self.children)

    def ranks(self) -> list[int]:
        out: list[int] = []
        for cs in self.children.values():
            out.extend(cs)
        return sorted(out)

    def spares(self) -> list[str]:
        """Empty (over-provisioned) daemons — the spare pool of §3.2."""
        return sorted(d for d, cs in self.children.items() if not cs)

    def least_loaded(self, exclude: Iterable[str] = ()) -> str:
        """argmin over |Children(d)| (Algorithm 1), ties broken by name for
        determinism."""
        ex = set(exclude)
        cands = [(len(cs), d) for d, cs in self.children.items()
                 if d not in ex]
        if not cands:
            raise RuntimeError("no surviving daemons")
        return min(cands)[1]


def root_handle_failure(view: ClusterView, failure: FailureEvent
                        ) -> ReinitCommand:
    """Algorithm 1 — Root: HandleFailure.

    Mutates `view` (removing a failed daemon / reassigning ranks) and
    returns the REINIT broadcast. Recovery is *non-shrinking*: every failed
    rank reappears in the command with a chosen parent daemon.
    """
    view.epoch += 1
    if failure.kind is FailureType.NODE:
        dead = failure.node
        assert dead is not None
        lost = sorted(view.children.pop(dead))
        target = view.least_loaded()
        view.children[target].update(lost)
        respawns = tuple(Respawn(daemon=target, rank=c) for c in lost)
    else:
        assert failure.rank is not None
        parent = view.parent(failure.rank)
        respawns = (Respawn(daemon=parent, rank=failure.rank),)
    return ReinitCommand(respawns=respawns, epoch=view.epoch)


def root_handle_failure_shrink(view: ClusterView, failure: FailureEvent
                               ) -> ShrinkCommand:
    """Shrinking recovery (the paper's deferred future work, ReStore-style):
    instead of re-hosting the lost ranks, drop them from the world.

    Mutates `view` (removing the failed daemon / rank, reassigning nothing)
    and returns the SHRINK broadcast: the dropped ranks and the surviving
    world. Survivors roll back to the consistent cut and re-balance the
    batch over the contracted world — no respawn anywhere."""
    view.epoch += 1
    if failure.kind is FailureType.NODE:
        dead = failure.node
        assert dead is not None
        dropped = tuple(sorted(view.children.pop(dead)))
    else:
        assert failure.rank is not None
        parent = view.parent(failure.rank)
        view.children[parent].discard(failure.rank)
        dropped = (failure.rank,)
    world = tuple(view.ranks())
    assert world, "shrink removed the last rank"
    return ShrinkCommand(dropped=dropped, epoch=view.epoch, world=world)


def root_handle_failure_promote(view: ClusterView, failure: FailureEvent,
                                shadows: Dict[int, str]) -> PromoteCommand:
    """Zero-rollback failover: each failed rank is replaced in place by
    its warm shadow, hosted on the shadow's daemon.

    `shadows` maps rank -> daemon hosting that rank's shadow. Mutates
    `view` (the failed rank moves to the shadow's daemon — the world's
    rank *set* never changes) and returns the PROMOTE broadcast.
    Raises KeyError if any failed rank has no warm shadow — the caller
    falls back to Algorithm 1 (respawn) for those.
    """
    if failure.kind is FailureType.NODE:
        dead = failure.node
        assert dead is not None
        lost = sorted(view.children.get(dead, ()))
    else:
        assert failure.rank is not None
        lost = [failure.rank]
    missing = [r for r in lost if r not in shadows]
    if missing:
        raise KeyError(f"no warm shadow for ranks {missing}")
    view.epoch += 1
    if failure.kind is FailureType.NODE:
        view.children.pop(dead, None)
    promotions = []
    for r in lost:
        home = shadows[r]
        if failure.kind is not FailureType.NODE:
            view.children[view.parent(r)].discard(r)
        view.children.setdefault(home, set()).add(r)
        promotions.append(Promotion(rank=r, daemon=home))
    return PromoteCommand(promotions=tuple(promotions), epoch=view.epoch,
                          world=tuple(view.ranks()))


def root_handle_rejoin(view: ClusterView, node: str,
                       ranks: Iterable[int]) -> GrowCommand:
    """Grow-back (the inverse of shrinking recovery): a repaired node's
    daemon re-registered and the admission policy re-admits `ranks` onto
    it. Mutates `view` (the node reappears owning the re-admitted ranks)
    and returns the GROW broadcast. The re-admitted ranks must be outside
    the current world — a rejoin never steals live ranks."""
    added = tuple(sorted(int(r) for r in ranks))
    assert added, "rejoin with no ranks to re-admit"
    live = set(view.ranks())
    assert live.isdisjoint(added), f"rejoin of live ranks {added}"
    assert node not in view.children or not view.children[node], \
        f"rejoined node {node!r} already owns ranks"
    view.epoch += 1
    view.children[node] = set(added)
    return GrowCommand(added=added, epoch=view.epoch,
                       world=tuple(view.ranks()), node=node)


@dataclasses.dataclass
class DaemonActions:
    """What one daemon does upon receiving REINIT (Algorithm 2)."""
    daemon: str
    signal_survivors: tuple[int, ...]       # SIGREINIT -> roll back
    spawn: tuple[int, ...]                  # re-spawned, state=RESTARTED

    def states(self) -> Dict[int, RankState]:
        st = {r: RankState.REINITED for r in self.signal_survivors}
        st.update({r: RankState.RESTARTED for r in self.spawn})
        return st


def daemon_handle_reinit(view: ClusterView, daemon: str,
                         cmd: ReinitCommand) -> DaemonActions:
    """Algorithm 2 — Daemon d̂: HandleReinit.

    Survivors = current children minus the ranks this daemon must spawn.
    """
    spawn = tuple(sorted(r.rank for r in cmd.respawns if r.daemon == daemon))
    children = view.children.get(daemon, set())
    survivors = tuple(sorted(children - set(spawn)))
    return DaemonActions(daemon=daemon, signal_survivors=survivors,
                         spawn=spawn)


def apply_recovery(view: ClusterView, cmd: ReinitCommand
                   ) -> Dict[int, RankState]:
    """Runs Algorithm 2 on every daemon; returns the post-recovery state of
    every rank. Invariants (property-tested):
      - the world is non-shrinking: rank set before == after,
      - every failed rank is RESTARTED exactly once,
      - every survivor is REINITED exactly once.
    """
    states: Dict[int, RankState] = {}
    for d in view.daemons():
        acts = daemon_handle_reinit(view, d, cmd)
        for r, s in acts.states().items():
            assert r not in states, f"rank {r} handled twice"
            states[r] = s
    return states
