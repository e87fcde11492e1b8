"""Event and state vocabulary of the Reinit++ protocol (paper §3.1).

`RankState` mirrors MPI_Reinit_state_t exactly:
  NEW       — first execution of the resilient function
  REINITED  — survivor that rolled back after a failure
  RESTARTED — failed process re-spawned to resume

Failures are fail-stop, of an MPI process or of a daemon (≡ node).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional


class RankState(enum.Enum):
    NEW = "MPI_REINIT_NEW"
    REINITED = "MPI_REINIT_REINITED"
    RESTARTED = "MPI_REINIT_RESTARTED"


class FailureType(enum.Enum):
    PROCESS = "process"
    NODE = "node"


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    kind: FailureType
    rank: Optional[int] = None       # failed MPI process (PROCESS failures)
    node: Optional[str] = None       # failed daemon/node (NODE failures)
    at_step: Optional[int] = None    # iteration at which it was injected
    wallclock: float = dataclasses.field(default_factory=time.monotonic)

    def __str__(self):
        tgt = f"rank {self.rank}" if self.kind is FailureType.PROCESS \
            else f"node {self.node}"
        return f"<{self.kind.value} failure of {tgt} @step {self.at_step}>"


@dataclasses.dataclass(frozen=True)
class Respawn:
    """One ⟨parent daemon, child rank⟩ pair from Algorithm 1's REINIT msg."""
    daemon: str
    rank: int


@dataclasses.dataclass(frozen=True)
class ReinitCommand:
    """The broadcast the root sends to all daemons on a failure."""
    respawns: tuple[Respawn, ...]
    epoch: int                       # recovery epoch (monotonically grows)


@dataclasses.dataclass(frozen=True)
class ShrinkCommand:
    """The broadcast of a shrinking recovery: no respawns — the dropped
    ranks leave the world and survivors re-balance over what remains."""
    dropped: tuple[int, ...]
    epoch: int
    world: tuple[int, ...]           # surviving rank ids (sorted)


@dataclasses.dataclass(frozen=True)
class GrowCommand:
    """The broadcast of a grow-back: a repaired node re-registered
    (REJOIN) and the admission policy re-admits previously dropped ranks
    onto it. Survivors roll back to the pinned pre-shrink cut and the
    re-admitted ranks restore from their last durable checkpoints; the
    world re-expands and the mesh epoch bumps (new logical shape)."""
    added: tuple[int, ...]           # ranks re-entering the world
    epoch: int
    world: tuple[int, ...]           # full rank membership after the grow
    node: str                        # the rejoined daemon hosting `added`
    mesh_epoch: int = 0


@dataclasses.dataclass(frozen=True)
class Promotion:
    """One ⟨failed rank, shadow's hosting daemon⟩ pair: the shadow that
    was warming that rank's delta stream takes over the rank id."""
    rank: int
    daemon: str


@dataclasses.dataclass(frozen=True)
class PromoteCommand:
    """The broadcast of a zero-rollback failover: no respawns and no
    rollback — each failed rank is replaced in place by its warm shadow.
    Survivors stay parked at the stalled step; the promoted shadows
    simply complete it. The mesh shape is unchanged, so the mesh epoch
    does NOT bump (compiled steps stay valid everywhere)."""
    promotions: tuple[Promotion, ...]
    epoch: int
    world: tuple[int, ...]           # full rank membership (unchanged set)


@dataclasses.dataclass
class RecoveryReport:
    """Timings of one recovery, broken down the way the paper reports them
    (Figures 4/6/7): detection, MPI recovery, checkpoint read."""
    strategy: str
    failure: FailureEvent
    detect_s: float = 0.0
    mpi_recovery_s: float = 0.0
    ckpt_read_s: float = 0.0
    rollback_step: int = 0
    world_after: Optional[int] = None   # set by a shrinking recovery

    @property
    def total_s(self) -> float:
        return self.detect_s + self.mpi_recovery_s + self.ckpt_read_s
