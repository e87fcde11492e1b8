"""Failure detectors for the three substrates.

- ChildMonitor: daemon-side, POSIX wait-based (SIGCHLD semantics) — detects
  crashed child worker processes.
- ChannelMonitor: root-side, detects broken daemon control channels (proxy
  for node failures).
- HeartbeatModel: ULFM-style always-on heartbeat — not used by Reinit++
  (one of the paper's findings is precisely that its absence keeps
  fault-free time clean); the trainer/sim charge its overhead to the ULFM
  strategy.
- FaultInjector: the paper's evaluation methodology (§4 "Emulating
  failures"): at a pre-drawn random iteration, a pre-drawn random rank (or
  its node) is killed. Deterministic per seed so every strategy sees the
  identical failure.
"""
from __future__ import annotations

import dataclasses
import os
import random
import signal
import threading
import time
from typing import Callable, Dict, Optional

from .events import FailureEvent, FailureType


class ChildMonitor:
    """Watches child PIDs; invokes callback(rank, pid, returncode) when one
    dies. Poll-based (portable SIGCHLD equivalent) with a tight period."""

    def __init__(self, on_death: Callable[[int, int, int], None],
                 period_s: float = 0.02):
        self._children: Dict[int, int] = {}       # rank -> pid
        self._on_death = on_death
        self._period = period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def watch(self, rank: int, pid: int):
        with self._lock:
            self._children[rank] = pid

    def unwatch(self, rank: int):
        with self._lock:
            self._children.pop(rank, None)

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _loop(self):
        while not self._stop.is_set():
            dead = []
            with self._lock:
                items = list(self._children.items())
            for rank, pid in items:
                try:
                    got, status = os.waitpid(pid, os.WNOHANG)
                    if got == pid:
                        dead.append((rank, pid, status))
                except ChildProcessError:
                    dead.append((rank, pid, -1))
            for rank, pid, status in dead:
                self.unwatch(rank)
                self._on_death(rank, pid, status)
            self._stop.wait(self._period)


class ChannelMonitor:
    """Root-side liveness via open channels: a broken/EOF channel marks the
    daemon (and transitively its node) failed."""

    def __init__(self, on_daemon_death: Callable[[str], None]):
        self._on_death = on_daemon_death
        self._alive: Dict[str, bool] = {}

    def register(self, daemon: str):
        self._alive[daemon] = True

    def channel_broken(self, daemon: str):
        if self._alive.get(daemon):
            self._alive[daemon] = False
            self._on_death(daemon)


@dataclasses.dataclass(frozen=True)
class HeartbeatModel:
    """ULFM-style heartbeat cost model [Bosilca et al., 2018]: each rank
    observes its successor on a period; the always-on observation plus the
    fault-tolerant wrappers around communication primitives inflate
    fault-free execution — measurably so at scale (paper Fig. 5).

    per_step_overhead(n) is charged to every application step under ULFM:
    a fixed wrapper cost plus a slowly growing term for network noise on
    larger rings (empirical fit to Fig. 5's divergence).
    """
    period_s: float = 0.1
    wrapper_cost_s: float = 2.0e-4
    noise_coeff_s: float = 8.0e-4

    def per_step_overhead(self, n_ranks: int) -> float:
        import math
        return self.wrapper_cost_s + self.noise_coeff_s * math.log2(max(n_ranks, 2)) ** 2

    def detection_latency(self) -> float:
        """Expected time to observe a dead neighbour: half a period."""
        return self.period_s / 2


@dataclasses.dataclass
class ScenarioInjector:
    """Replays a declarative Scenario's step-triggered faults against an
    in-process driver (the trainer / the simulator): `check(step, view)`
    returns the FailureEvent of the first un-fired fault due at `step`.

    This is the generalization of the original single-(step, rank)
    FaultInjector: any number of faults, rank or node targets, each fired
    exactly once — the scenario file, not code, decides the shape.
    Phase-point faults (mid-checkpoint-write, mid-recovery) don't flow
    through check(); they fire through repro_torch.scenarios.hooks at the named
    interruption points of the real runtime."""
    scenario: "object"                 # scenarios.schema.Scenario
    enabled: bool = True

    def __post_init__(self):
        self._fired: set = set()
        self._fired_repairs: set = set()

    def reset(self):
        self._fired.clear()
        self._fired_repairs.clear()
        self.enabled = True

    def _to_event(self, f, step, view) -> FailureEvent:
        if f.target == "node":
            node = view.parent(f.rank) if view is not None else None
            return FailureEvent(kind=FailureType.NODE, node=node,
                                rank=f.rank, at_step=step)
        return FailureEvent(kind=FailureType.PROCESS, rank=f.rank,
                            at_step=step)

    def check(self, step: int, view=None) -> Optional[FailureEvent]:
        return self.check_point("step", step=step, view=view)

    def check_point(self, point: str, step: Optional[int] = None,
                    view=None, eligible=None) -> Optional[FailureEvent]:
        """First un-fired fault due at the named interruption point —
        `step` faults at the top of iteration N, checkpoint-phase faults
        at the matching save step, cascade faults (step=None wildcard) at
        their first firing opportunity during a recovery. This is how the
        in-process trainer reaches the same injection points the real
        runtime fires through repro_torch.scenarios.hooks.

        `eligible(fault) -> bool` defers a matching fault without
        claiming it (e.g. a cascade whose victim rank is currently
        dropped from the world: its next incarnation only exists at the
        grow that re-admits it, where the next check fires it)."""
        if not self.enabled:
            return None
        # method-level import: schema -> core.recovery -> core/__init__
        # -> failure would cycle at module import time
        from repro_torch.scenarios.schema import GRAY_HOWS
        for i, f in enumerate(self.scenario.faults):
            if i in self._fired or f.point != point \
                    or f.target == "root":
                continue
            if f.how in GRAY_HOWS:
                # gray faults degrade, they never kill: the trainer/sim
                # apply them through the straggler path, not as events
                continue
            if f.step is not None and step is not None and f.step != step:
                continue
            if eligible is not None and not eligible(f):
                continue
            self._fired.add(i)
            return self._to_event(f, step, view)
        return None

    def check_repair(self, step: int):
        """The node repair (if any) due at `step`'s checkpoint boundary —
        fired exactly once; the elastic driver turns it into a REJOIN ->
        GROW / spare-grant transition."""
        if not self.enabled:
            return None
        for i, r in enumerate(getattr(self.scenario, "repairs", ())):
            if i in self._fired_repairs or r.step != step:
                continue
            self._fired_repairs.add(i)
            return r
        return None


@dataclasses.dataclass
class FaultInjector(ScenarioInjector):
    """Pre-draws (step, rank) so every strategy replays the same failure —
    the paper's §4 methodology, kept as a thin shim over ScenarioInjector:
    the drawn (step, rank) becomes a one-fault Scenario.

    kind=NODE kills the rank's whole node (the paper has the victim signal
    its parent daemon instead of itself).
    """
    scenario: "object" = None          # synthesized in __post_init__
    n_ranks: int = 0
    n_steps: int = 0
    kind: FailureType = FailureType.PROCESS
    seed: int = 0

    def __post_init__(self):
        from repro_torch.scenarios.schema import Fault, Scenario, Topology
        rng = random.Random(self.seed)
        lo = max(1, self.n_steps // 4)
        hi = max(lo + 1, (3 * self.n_steps) // 4)
        self.fail_step = rng.randint(lo, hi)
        self.fail_rank = rng.randrange(self.n_ranks)
        target = "node" if self.kind is FailureType.NODE else "rank"
        self.scenario = Scenario(
            name=f"drawn-seed{self.seed}",
            topology=Topology(nodes=1, ranks_per_node=self.n_ranks,
                              spares=0),
            steps=max(self.n_steps, self.fail_step + 1),
            faults=(Fault(target, self.fail_rank, self.fail_step),),
        )
        super().__post_init__()

    def check(self, step: int, view=None) -> Optional[FailureEvent]:
        ev = super().check(step, view)
        if ev is not None:
            self.enabled = False      # single failure per run (paper §4)
        return ev


def kill_process(pid: int):
    """SIGKILL — the injection primitive used by the process runtime."""
    os.kill(pid, signal.SIGKILL)
