"""Recovery strategies: CR / Reinit++ / ULFM — one protocol, three costs.

Each strategy declares *what actually happens* on failure; the trainer
executes those actions for real (reload files, restore buddy shards, drop
compiled-step caches, run agreement collectives) and the simulator charges
their calibrated large-scale costs. The asymmetries the paper measures:

  CR        tear down + re-deploy the job; file checkpoints only; compiled
            artifacts and device state all lost.
  Reinit++  root↔daemon tree recovery; survivors keep process + device
            state; memory (buddy) checkpoints valid for process failures.
  ULFM      all-rank revoke/shrink/agree collectives; survivors keep
            process; always-on heartbeat taxes every fault-free step.
  Replica   shadow ranks consume the buddy delta stream every step; a
            failure is repaired by promoting the warm shadow in place —
            no rollback, no respawn, no recomputed steps. The stream
            fan-out taxes every fault-free step instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .events import FailureEvent, FailureType
from .failure import HeartbeatModel


@dataclasses.dataclass(frozen=True)
class RecoveryStrategy:
    name: str
    # costs that exist at any scale
    redeploys: bool                      # CR: full job teardown + relaunch
    keeps_jit_cache: bool                # survivors keep compiled steps
    # recovery communication shape
    allrank_collectives: int             # ULFM: shrink/agree/merge rounds
    tree_broadcasts: int                 # Reinit++: root->daemon REINIT
    # fault-free overhead
    heartbeat: Optional[HeartbeatModel]  # ULFM only
    # pipelined recovery: survivors redistribute/restore state while the
    # replacement ranks are still spawning (the REINIT broadcast carries
    # enough context to start the restore early). CR cannot overlap —
    # nothing survives the teardown to do the restoring.
    overlap_restore: bool = False
    # replication: shadow ranks hold warm state and failover is an
    # in-place promotion (no rollback-to-checkpoint on the critical path)
    replicates: bool = False

    def checkpoint_kind(self, failure: FailureType) -> str:
        from repro_torch.checkpoint.policy import checkpoint_kind_for
        key = "node" if failure is FailureType.NODE else "process"
        return checkpoint_kind_for(key, self.key)

    @property
    def key(self) -> str:
        return {"CR": "cr", "Reinit++": "reinit", "ULFM": "ulfm",
                "Shrink": "shrink", "Replica": "replica"}[self.name]

    def fault_free_overhead(self, n_ranks: int,
                            stream_mb_per_rank: float = 0.0,
                            nic_bw_MBps: float = 1_200.0) -> float:
        """Per-step tax this strategy pays when nothing fails.

        ULFM pays its heartbeat; Replica pays the extra delta-frame push
        to the shadow (one more NIC copy per rank per step — pairs are
        parallel, so it scales with the per-rank frame size, not the
        world size). The other strategies are free when healthy."""
        cost = self.heartbeat.per_step_overhead(n_ranks) if self.heartbeat \
            else 0.0
        if self.replicates and stream_mb_per_rank > 0.0:
            cost += stream_mb_per_rank / nic_bw_MBps
        return cost


CR = RecoveryStrategy(
    name="CR", redeploys=True, keeps_jit_cache=False,
    allrank_collectives=0, tree_broadcasts=0, heartbeat=None,
    overlap_restore=False)

REINIT = RecoveryStrategy(
    name="Reinit++", redeploys=False, keeps_jit_cache=True,
    allrank_collectives=0, tree_broadcasts=1, heartbeat=None,
    overlap_restore=True)

ULFM = RecoveryStrategy(
    name="ULFM", redeploys=False, keeps_jit_cache=True,
    # revoke + shrink + agree + spawn/merge — each an all-rank operation;
    # the agreement rounds serialize against the restore, no overlap
    allrank_collectives=4, tree_broadcasts=0, heartbeat=HeartbeatModel())

# Elastic shrinking recovery (beyond the paper — its deferred future work,
# made practical by ReStore-style replicated in-memory state): behaves like
# Reinit++ while the spare pool holds, and contracts the data axis instead
# of respawning once it is exhausted. Survivors keep process + device
# state; a shrink bumps the mesh epoch, so compiled steps are dropped.
SHRINK = RecoveryStrategy(
    name="Shrink", redeploys=False, keeps_jit_cache=True,
    allrank_collectives=0, tree_broadcasts=1, heartbeat=None,
    overlap_restore=True)

# Zero-rollback replica failover (FTHP-MPI / PartRePer-MPI lineage):
# shadow ranks drawn from the spare pool apply the buddy delta stream as
# it flows, so they always hold the state of the current step. Failover
# is PROMOTE shadow + re-form ring + resume — survivors never roll back
# and the failed step is never recomputed. The price is paid fault-free:
# one extra NIC push per rank per step, plus a shadow process per
# protected rank.
REPLICA = RecoveryStrategy(
    name="Replica", redeploys=False, keeps_jit_cache=True,
    allrank_collectives=0, tree_broadcasts=1, heartbeat=None,
    overlap_restore=True, replicates=True)

STRATEGIES = {s.key: s for s in (CR, REINIT, ULFM, SHRINK, REPLICA)}

# Accepted spellings → canonical strategy keys. This is the single alias
# table; scenarios/schema.py re-exports it so the CLI, the scenario
# schema and this registry can never drift apart.
STRATEGY_ALIASES = {
    "reinit++": "reinit",
    "reinitpp": "reinit",
    "restart": "cr",
    "ulfm-shrink": "ulfm",
    "elastic": "shrink",
}


def get_strategy(name: str) -> RecoveryStrategy:
    """Resolve a strategy by key or documented alias.

    Raises ValueError on empty/ambiguous input (e.g. "++", which older
    normalization silently collapsed to "" and then mis-reported as an
    unknown strategy) and KeyError on a genuinely unknown name."""
    if not isinstance(name, str) or not name.strip():
        raise ValueError(f"empty or non-string strategy name: {name!r}")
    k = name.strip().lower()
    k = STRATEGY_ALIASES.get(k, k)
    if not k or k not in STRATEGIES:
        known = sorted(set(STRATEGIES) | set(STRATEGY_ALIASES))
        raise KeyError(f"unknown strategy {name!r}; known: {known}")
    return STRATEGIES[k]
