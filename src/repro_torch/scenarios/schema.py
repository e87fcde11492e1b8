"""Declarative failure-scenario schema.

A `Scenario` is a pure data description of one fault-injected execution:

  who fails    Fault.target — an MPI "rank", its whole "node" (the parent
               daemon and every child), or the "root" (HNP) itself;
  when         Fault.step + Fault.point — at the top of iteration N
               ("step", behind the FENCE kill barrier so the cut is a
               deterministic consistent cut), mid-checkpoint-write
               ("worker.ckpt.mid_write": the shard is on disk but not yet
               renamed), mid-replication ("worker.ckpt.pre_push": the file
               committed but the buddy copy never sent), or *during an
               in-flight recovery* ("worker.recovery.*": the ReStore-style
               cascading failures — a replacement dying mid-restore, a
               survivor dying right after rollback, a kill mid
               delta-chain-compose);
  how          Fault.how — SIGKILL, a broken control channel, or a silent
               hang (caught by the root's stall watchdog).

The same Scenario object drives both executors (repro.scenarios.engine):
the discrete-event simulator charges each phase its calibrated cost over
the real Algorithm-1/2 protocol, and the real-process runtime replays the
faults on live POSIX processes. The schema stays jax-free on purpose — it
is imported by repro_torch.core.failure and by the worker subprocesses; its only
non-stdlib import is core.recovery's strategy registry (itself jax-free),
so the strategy keys have exactly one source of truth.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

# "shadow" targets the warm replica of `rank` (replica strategy): the
# shadow process dies, the rank silently loses its zero-rollback cover,
# and the next failure of that rank falls back to global-restart.
TARGETS = ("rank", "node", "root", "shadow")
# "slow" and "lossy" are the *gray* failure mechanisms: the victim keeps
# running (nothing dies, nothing signals) but degrades — a slow rank's
# compute stretches by Fault.factor, a lossy rank's control-channel
# sends pay seeded delay/retransmit. Detection is statistical (per-rank
# barrier-arrival lateness through StragglerTracker), and the response
# is a *policy*: Scenario.mitigate=False tolerates the degradation to
# the end of the run; mitigate=True drains the victim through the
# ordinary loss path (SHRINK when the pool is empty, grow-back on
# repair) once the lateness persists GRAY_DRAIN_PERSIST barriers.
HOWS = ("sigkill", "channel_break", "hang", "slow", "lossy")
GRAY_HOWS = ("slow", "lossy")

#: nominal healthy per-step quantum the gray degradation scales against:
#: a factor-k victim is delayed (k-1) * GRAY_STEP_S per step — large
#: against scheduling noise (~ms), small against the run (~s).
GRAY_STEP_S = 0.1
#: consecutive late barriers before a mitigating root drains the victim
#: (one flagged barrier is noise; two in a row is a trend)
GRAY_DRAIN_PERSIST = 2


def gray_delay_s(f: "Fault") -> float:
    """Injected per-step delay of a factor-k gray fault."""
    return (f.factor - 1.0) * GRAY_STEP_S


def gray_drain_cut(f: "Fault") -> int:
    """The consistent cut a mitigating drain resumes from. Lateness is
    first observable at barrier f.step (the first degraded iteration),
    the drain fires once it persists, i.e. at the completion of barrier
    f.step + GRAY_DRAIN_PERSIST - 1 — whose release the root withholds,
    making that barrier's step the deterministic consensus cut (every
    rank arrived, so every rank committed that step's checkpoint)."""
    return f.step + GRAY_DRAIN_PERSIST - 1

# Named interruption points. "step" is the only fenced point (the victim
# declares intent and dies only once every survivor has committed the
# fence step's checkpoint); the others interrupt a specific phase of the
# checkpoint or recovery machinery and rely on the rollback consensus
# (resume = min over ranks) for a consistent cut.
POINTS = (
    "step",                      # top of the BSP loop at iteration `step`
    "worker.ckpt.mid_write",     # rank file written to tmp, not renamed
    "worker.ckpt.pre_push",      # rank file committed, buddy push not sent
    "worker.recovery.enter",     # survivor just rolled back (REINITED)
    "worker.recovery.pulled",    # restoring rank gathered its frames
    "worker.recovery.compose",   # mid delta-chain compose of the restore
    # FileCheckpointer-internal points (unit-level crash tests / trainer)
    "ckpt.file.shard",           # one shard's bytes written
    "ckpt.file.pre_commit",      # shards + manifest down, COMMITTED not
    "ckpt.file.compose",         # applying a delta frame during load
    "ckpt.file.rebase.begin",    # background re-base starting its compose
    "ckpt.file.rebase.pre_commit",  # re-based frame staged, not renamed
)

CASCADE_POINTS = tuple(p for p in POINTS if p.startswith("worker.recovery."))

#: exit code of an injected root self-kill: the runtime root exits with it
#: (runtime.root) and the engine recognizes it as "relaunch me" (external
#: job restart). Lives here so both sides share one definition.
ROOT_INJECTED_EXIT = 42

#: strategy keys a scenario may request; "ulfm" is sim-only (the measured
#: runtime implements reinit, cr, shrink and replica — see
#: engine.real_strategies). "shrink" is elastic recovery: spare-pool
#: re-hosting while spares last, world contraction once the pool is
#: exhausted. "replica" is zero-rollback failover: warm shadows promote
#: in place, a warm standby absorbs root loss.
#: The key set and alias table live in core.recovery — the strategy
#: registry is the single source of truth the drift-guard test pins.
from repro_torch.core.recovery import STRATEGIES as _STRATEGIES
from repro_torch.core.recovery import STRATEGY_ALIASES

STRATEGY_KEYS = tuple(_STRATEGIES)


def normalize_strategy(name: str) -> str:
    k = STRATEGY_ALIASES.get(name.lower(), name.lower())
    if k not in STRATEGY_KEYS:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"known: {STRATEGY_KEYS + tuple(STRATEGY_ALIASES)}")
    return k


@dataclasses.dataclass(frozen=True)
class Topology:
    """Deployment tree shape (paper Fig. 3)."""
    nodes: int = 2
    ranks_per_node: int = 2
    spares: int = 1

    @property
    def world(self) -> int:
        return self.nodes * self.ranks_per_node

    def validate(self):
        if self.nodes < 1 or self.ranks_per_node < 1 or self.spares < 0:
            raise ValueError(f"bad topology {self}")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected failure. `rank` is the victim rank; for target="node"
    it selects the node hosting that rank; for target="root" it is
    ignored. `step` is the trigger iteration for point="step", the *save*
    step for the worker.ckpt.* points, and None (wildcard) for the
    recovery points, which fire at most once during the recovery that
    follows the previous fault.

    `factor` is only meaningful for the gray hows (`slow`, `lossy`): the
    degradation multiple (x-k deceleration / per-send delay scale); the
    victim's per-step penalty is (factor - 1) * GRAY_STEP_S. Gray faults
    are active from iteration `step` for the rest of the incarnation —
    a drained-and-respawned victim comes back healthy (degradation
    models a sick host, and a re-host moves off it)."""
    target: str = "rank"
    rank: int = 0
    step: Optional[int] = None
    point: str = "step"
    how: str = "sigkill"
    factor: float = 0.0

    def validate(self, topo: Topology, position: int):
        if self.target not in TARGETS:
            raise ValueError(f"fault target {self.target!r} not in {TARGETS}")
        if self.how not in HOWS:
            raise ValueError(f"fault how {self.how!r} not in {HOWS}")
        if self.point not in POINTS:
            raise ValueError(f"fault point {self.point!r} not in {POINTS}")
        if self.how in GRAY_HOWS:
            if self.target not in ("rank", "node"):
                raise ValueError(f"{self.how} faults degrade a rank/node "
                                 "(nothing else runs the BSP loop)")
            if self.point != "step":
                raise ValueError(f"{self.how} faults use point='step' "
                                 "(degradation starts at an iteration, "
                                 "not inside a checkpoint phase)")
            if not self.factor > 1.0:
                raise ValueError(f"{self.how} faults need factor > 1.0 "
                                 "(the degradation multiple)")
            if self.step is None or self.step < 2:
                raise ValueError(f"{self.how} faults need step >= 2: the "
                                 "lateness detector needs at least two "
                                 "healthy barriers as its baseline")
        elif self.factor != 0.0:
            raise ValueError(f"factor only applies to {GRAY_HOWS} faults")
        if self.target == "root":
            if self.how != "sigkill" or self.point != "step":
                raise ValueError("root faults support only sigkill @step")
        elif not (0 <= self.rank < topo.world):
            raise ValueError(f"victim rank {self.rank} outside world "
                             f"{topo.world}")
        if self.how == "hang" and self.target == "root":
            raise ValueError("hang faults only defined for rank/node")
        if self.target == "shadow" and (self.how != "sigkill"
                                        or self.point != "step"):
            raise ValueError("shadow faults support only sigkill @step "
                             "(the shadow runs no BSP loop to interrupt)")
        if self.point in CASCADE_POINTS:
            if position == 0:
                raise ValueError(f"{self.point} is a cascade point: it "
                                 "only fires during a recovery, so it "
                                 "cannot be the first fault")
            if self.step is not None:
                raise ValueError("recovery-point faults take step=None")
        elif self.step is None or self.step < 1:
            raise ValueError(f"fault at {self.point} needs step >= 1")
        if self.point.startswith(("worker.ckpt.", "ckpt.file.")) \
                and self.target != "rank":
            raise ValueError("checkpoint-phase faults target a rank")


@dataclasses.dataclass(frozen=True)
class Repair:
    """One node repair: the node that originally hosted `rank` (and has
    since died or been dropped) comes back — its daemon restarts at the
    `step` checkpoint boundary and re-registers with the root (REJOIN).

    Only the elastic runtime acts on it: the admission policy re-admits
    dropped ranks (GROW, at the next checkpoint boundary) when the world
    is shrunk, and otherwise adds the node to the spare pool. Non-elastic
    strategies ignore repairs — their world never shrank."""
    rank: int
    step: int

    def validate(self, topo: "Topology", steps: int):
        if not (0 <= self.rank < topo.world):
            raise ValueError(f"repair rank {self.rank} outside world "
                             f"{topo.world}")
        if not (1 <= self.step < steps):
            raise ValueError(f"repair step {self.step} outside run "
                             f"[1, {steps})")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A complete, reproducible failure experiment."""
    name: str
    faults: tuple[Fault, ...]
    topology: Topology = Topology()
    repairs: tuple[Repair, ...] = ()    # node repairs (elastic grow-back)
    steps: int = 6                      # application iterations
    dim: int = 64                       # per-rank state size
    # smallest legal world, in whole data-parallel groups: the elastic
    # strategy refuses to shrink below min_data_parallel * ranks_per_node
    min_data_parallel: int = 1
    strategies: tuple[str, ...] = ("reinit", "cr", "ulfm")
    expect_bit_identical: bool = True   # recovered == fault-free state
    # gray-failure policy knob (threaded root -> trainer -> sim): False
    # tolerates a degraded member to the end of the run (no recovery, no
    # oracle entry — the run must still finish bit-identical); True
    # drains a persistently-late victim through the ordinary loss path
    # (SHRINK when the pool is empty; a Repair grows it back) with the
    # drain's consistent cut in the oracle. Only meaningful with gray
    # faults, and only the elastic strategy can execute a drain.
    mitigate: bool = False
    stall_timeout_s: float = 0.0        # >0 arms the root stall watchdog
    # >0 arms the neighbour-heartbeat ring on the real runtime: each rank
    # observes its ring successor every period and reports SUSPECT to the
    # root after timeout seconds of consecutive silence — hang cells then
    # measure detection instead of relying on the watchdog kill
    heartbeat_period_s: float = 0.0
    heartbeat_timeout_s: float = 0.0
    tags: tuple[str, ...] = ()
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        object.__setattr__(self, "repairs", tuple(self.repairs))
        object.__setattr__(self, "strategies",
                           tuple(normalize_strategy(s)
                                 for s in self.strategies))
        object.__setattr__(self, "tags", tuple(self.tags))
        self.validate()

    # ------------------------------------------------------- validation

    def validate(self):
        self.topology.validate()
        if not self.name:
            raise ValueError("scenario needs a name")
        if not self.faults and self.expect_bit_identical is False:
            raise ValueError("fault-free scenario must expect identity")
        for i, f in enumerate(self.faults):
            f.validate(self.topology, i)
            if f.step is not None and f.step >= self.steps:
                raise ValueError(f"fault step {f.step} >= run steps "
                                 f"{self.steps}")
        for r in self.repairs:
            r.validate(self.topology, self.steps)
        if self.min_data_parallel < 1:
            raise ValueError("min_data_parallel must be >= 1")
        if self.min_data_parallel > self.topology.nodes:
            raise ValueError(f"min_data_parallel {self.min_data_parallel} "
                             f"exceeds {self.topology.nodes} nodes")
        if (self.heartbeat_period_s > 0) != (self.heartbeat_timeout_s > 0):
            raise ValueError("heartbeat needs both period and timeout > 0")
        if any(f.how == "hang" for f in self.faults) \
                and self.stall_timeout_s <= 0 \
                and self.heartbeat_period_s <= 0:
            raise ValueError("hang faults need stall_timeout_s > 0 or an "
                             "armed heartbeat ring (nothing else detects "
                             "a silent rank)")
        if any(f.how == "hang" and f.target == "node"
               for f in self.faults) and self.heartbeat_period_s <= 0:
            raise ValueError("node-hang faults need the heartbeat ring: "
                             "the watchdog's KILL_RANK order goes through "
                             "the hung daemon and dies there — only the "
                             "daemon-level ring observation detects it")
        if not self.strategies:
            raise ValueError("scenario needs at least one strategy")
        if any(f.target == "shadow" for f in self.faults) \
                and "replica" not in self.strategies:
            raise ValueError("shadow faults only exist under the replica "
                             "strategy (no other strategy runs shadows)")
        gray = [f for f in self.faults if f.how in GRAY_HOWS]
        if self.mitigate:
            if not gray:
                raise ValueError("mitigate=True without a gray fault: "
                                 "there is nothing to drain")
            if set(self.strategies) != {"shrink"}:
                raise ValueError("mitigate=True needs strategies="
                                 "('shrink',): only the elastic strategy "
                                 "can drain and re-host a live member")
            for f in gray:
                if gray_drain_cut(f) >= self.steps - 1:
                    raise ValueError(
                        f"gray fault at step {f.step}: the drain cut "
                        f"{gray_drain_cut(f)} leaves no post-drain step "
                        f"in a {self.steps}-step run")

    # --------------------------------------------------------- queries

    def faults_for_rank(self, rank: int) -> list[tuple[int, Fault]]:
        """(index, fault) pairs whose injection is driven by `rank` —
        rank faults on the rank itself, node faults by the victim rank
        on that node (the paper has the victim signal its daemon). Gray
        faults are excluded: they are degradations, not kills, and are
        applied via `gray_faults_for_rank` instead."""
        return [(i, f) for i, f in enumerate(self.faults)
                if f.target in ("rank", "node") and f.rank == rank
                and f.how not in GRAY_HOWS]

    def gray_faults_for_rank(self, rank: int) -> list[tuple[int, Fault]]:
        """(index, fault) pairs degrading `rank`: rank-target gray faults
        on the rank itself, node-target gray faults on every rank the
        victim's node hosts (a sick host slows all its children)."""
        rpn = self.topology.ranks_per_node
        out = []
        for i, f in enumerate(self.faults):
            if f.how not in GRAY_HOWS:
                continue
            if f.target == "rank" and f.rank == rank:
                out.append((i, f))
            elif f.target == "node" and f.rank // rpn == rank // rpn:
                out.append((i, f))
        return out

    def root_faults(self) -> list[tuple[int, Fault]]:
        return [(i, f) for i, f in enumerate(self.faults)
                if f.target == "root"]

    def shadow_faults(self, rank: int) -> list[tuple[int, Fault]]:
        """(index, fault) pairs killing the warm shadow of `rank` —
        injected by the shadow process itself when the delta stream
        reaches the trigger step."""
        return [(i, f) for i, f in enumerate(self.faults)
                if f.target == "shadow" and f.rank == rank]

    @property
    def is_cascading(self) -> bool:
        return any(f.point in CASCADE_POINTS for f in self.faults)

    # ----------------------------------------------------------- serde

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "topology": dataclasses.asdict(self.topology),
            "repairs": [dataclasses.asdict(r) for r in self.repairs],
            "steps": self.steps,
            "dim": self.dim,
            "min_data_parallel": self.min_data_parallel,
            "strategies": list(self.strategies),
            "expect_bit_identical": self.expect_bit_identical,
            "mitigate": self.mitigate,
            "stall_timeout_s": self.stall_timeout_s,
            "heartbeat_period_s": self.heartbeat_period_s,
            "heartbeat_timeout_s": self.heartbeat_timeout_s,
            "tags": list(self.tags),
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        return cls(
            name=d["name"],
            description=d.get("description", ""),
            topology=Topology(**d.get("topology", {})),
            repairs=tuple(Repair(**r) for r in d.get("repairs", ())),
            steps=d.get("steps", 6),
            dim=d.get("dim", 64),
            min_data_parallel=d.get("min_data_parallel", 1),
            strategies=tuple(d.get("strategies", ("reinit", "cr", "ulfm"))),
            expect_bit_identical=d.get("expect_bit_identical", True),
            mitigate=d.get("mitigate", False),
            stall_timeout_s=d.get("stall_timeout_s", 0.0),
            heartbeat_period_s=d.get("heartbeat_period_s", 0.0),
            heartbeat_timeout_s=d.get("heartbeat_timeout_s", 0.0),
            tags=tuple(d.get("tags", ())),
            faults=tuple(Fault(**f) for f in d.get("faults", ())),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    def dump(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_json(f.read())


def _fault_resume(f: Fault) -> Optional[int]:
    if f.target in ("root", "shadow"):
        return None
    if f.point == "step":
        return f.step
    if f.point == "worker.ckpt.mid_write":
        return f.step - 1
    if f.point == "worker.ckpt.pre_push":
        return f.step
    return None


def elastic_transitions(scenario: Scenario) -> list:
    """Replay the elastic (shrink-strategy) membership policy over the
    scenario's declarative timeline: primary faults and node repairs
    merged in step order (a step-N fault fires at the top of iteration N,
    a step-N repair at that step's checkpoint boundary — fault first).
    Rank hosting and node aliveness are modeled by name, mirroring the
    executors: Algorithm 1 re-hosts a dead node's ranks onto the
    least-loaded survivor, and a repair names the rank's *initial* node.

    Returns [(kind, obj, resume)] where kind is:
      "respawn"  spare-absorbed / in-place / over-subscribed recovery
      "shrink"   pool exhausted, world contracted by the lost ranks
                 (a whole node group, or a single rank — whose home
                 node then stays alive)
      "grow"     a repair of a dead node re-admitted a dropped group —
                 its own when it has one, else the most recent; resume
                 = that shrink's consistent cut (the pinned anchor)
      "spare"    a repair of a dead node with nothing dropped: the
                 node rejoins the pool
      "noop"     a repair of a node that never left the world (e.g.
                 after a process-level shrink): the executors skip it
      "restart"  root loss (external job restart, timing-dependent cut)

    This is the same admission/floor policy `MembershipMachine` executes;
    the harness cross-checks the two derivations against each other."""
    topo = scenario.topology
    floor = scenario.min_data_parallel * topo.ranks_per_node
    rpn = topo.ranks_per_node
    hosts = {r: f"node{r // rpn}" for r in range(topo.world)}
    ranks_on = {f"node{n}": set(range(n * rpn, (n + 1) * rpn))
                for n in range(topo.nodes)}
    ranks_on.update({f"spare{s}": set() for s in range(topo.spares)})
    drop_groups: list = []        # (home_node_or_None, ranks, cut)

    def have_spare():
        return any(not rs for rs in ranks_on.values())

    def world_size():
        return sum(len(rs) for rs in ranks_on.values())

    # a mitigated gray fault becomes an ordinary loss at its drain (the
    # root kills the victim once lateness persists), so its timeline
    # position and cut are the drain's, not the onset step; an
    # unmitigated one never enters the membership timeline at all
    timeline = sorted(
        [((gray_drain_cut(f) if f.how in GRAY_HOWS
           else f.step if f.step is not None else -1), 0, i, "fault", f)
         for i, f in enumerate(scenario.faults)
         if f.point not in CASCADE_POINTS and f.target != "shadow"
         and (f.how not in GRAY_HOWS or scenario.mitigate)]
        + [(r.step, 1, i, "repair", r)
           for i, r in enumerate(scenario.repairs)],
        key=lambda e: e[:3])
    out = []
    for _, _, _, what, obj in timeline:
        if what == "fault":
            cut = gray_drain_cut(obj) if obj.how in GRAY_HOWS \
                else _fault_resume(obj)
            if obj.target == "root":
                # external job restart redeploys the full topology (the
                # executors rebuild view + machine): membership resets
                hosts = {r: f"node{r // rpn}" for r in range(topo.world)}
                ranks_on = {f"node{n}": set(range(n * rpn, (n + 1) * rpn))
                            for n in range(topo.nodes)}
                ranks_on.update({f"spare{s}": set()
                                 for s in range(topo.spares)})
                drop_groups.clear()
                out.append(("restart", obj, cut))
            elif obj.target == "node":
                dead = hosts.get(obj.rank)
                if dead is None:
                    continue            # victim already out of the world
                lost = ranks_on.pop(dead)
                if have_spare() or world_size() < floor:
                    # a spare absorbs it, or the floor forbids the
                    # shrink: Algorithm 1 re-hosts onto the
                    # least-loaded survivor (over-subscribing if none
                    # is empty)
                    target = min((len(rs), d)
                                 for d, rs in ranks_on.items())[1]
                    ranks_on[target] |= lost
                    for r in sorted(lost):
                        hosts[r] = target
                    out.append(("respawn", obj, cut))
                else:
                    for r in sorted(lost):
                        del hosts[r]
                    drop_groups.append((dead, sorted(lost), cut))
                    out.append(("shrink", obj, cut))
            else:                         # rank loss
                host = hosts.get(obj.rank)
                if host is None:
                    continue
                if not have_spare() and world_size() - 1 >= floor:
                    ranks_on[host].discard(obj.rank)
                    del hosts[obj.rank]
                    drop_groups.append((None, [obj.rank], cut))
                    out.append(("shrink", obj, cut))
                else:
                    out.append(("respawn", obj, cut))
        else:                             # repair
            node = f"node{obj.rank // rpn}"
            if node in ranks_on:
                # the node never left the world (it survived, or a
                # process-level shrink dropped only a rank of it):
                # the executors skip the repair entirely
                out.append(("noop", obj, None))
            elif drop_groups:
                idx = next((i for i in range(len(drop_groups) - 1, -1, -1)
                            if drop_groups[i][0] == node),
                           len(drop_groups) - 1)
                _, granks, cut = drop_groups.pop(idx)
                ranks_on[node] = set(granks)
                for r in granks:
                    hosts[r] = node
                out.append(("grow", obj, cut))
            else:
                ranks_on[node] = set()
                out.append(("spare", obj, None))
    return out


def expected_resume_steps(scenario: Scenario,
                          strategy: Optional[str] = None) -> list:
    """The consistent cuts the rollback consensus must land on — one entry
    per *primary* (non-cascade) fault, in injection order; the shared
    oracle both executors are checked against. A None entry means that
    recovery's resume step is legitimately timing-dependent (root faults),
    and only bit-identity is asserted for it.

      step                 victim dies behind the FENCE: every rank has
                           committed checkpoint `step`  -> resume = step
      worker.ckpt.mid_write  victim dies with save `step` un-renamed; its
                           newest durable state is step-1 and min() over
                           ranks rules                  -> resume = step-1
      worker.ckpt.pre_push   the file committed before death, and the
                           restore merges buddy + file  -> resume = step
      cascades             a second failure during recovery replays the
                           same consensus over the same frames — the
                           primary fault's cut stands (no extra entry).

    Sequential primary faults (double node loss, spare-pool exhaustion)
    each trigger their own recovery and therefore their own entry.

    Under the elastic strategy (`strategy="shrink"`) node repairs add
    entries of their own: a grow-back's consensus lands exactly on the
    cut of the shrink it reverses (the rejoining ranks' newest durable
    checkpoint — which the survivors kept pinned as the grow anchor).
    Non-elastic strategies ignore repairs, so their oracle is unchanged.

    Gray faults (`slow`/`lossy`) add an entry only when the scenario
    mitigates under the elastic strategy: the drain is an ordinary loss
    at `gray_drain_cut` (the barrier whose release the root withheld).
    Tolerated gray faults trigger no recovery at all — their oracle is
    empty and the executors must report zero consensus entries.
    """
    include_gray = scenario.mitigate and (
        strategy is None or normalize_strategy(strategy) == "shrink")
    if strategy is not None and normalize_strategy(strategy) == "shrink" \
            and scenario.repairs:
        return [cut for kind, _, cut in elastic_transitions(scenario)
                if kind not in ("spare", "noop")]
    # shadow faults never interrupt the application: no consensus entry.
    # Replica promotions resume exactly at the step-point cut, the same
    # value the fence oracle already yields — so the default table below
    # is shared by every strategy (a replica fallback on a ckpt-phase
    # fault degrades to Reinit++, whose cut it also shares).
    return [(gray_drain_cut(f) if f.how in GRAY_HOWS else _fault_resume(f))
            for f in scenario.faults
            if f.point not in CASCADE_POINTS and f.target != "shadow"
            and (f.how not in GRAY_HOWS or include_gray)]


def expected_resume_step(scenario: Scenario) -> Optional[int]:
    """Back-compat single-fault view: the first primary fault's cut."""
    steps = expected_resume_steps(scenario)
    return steps[0] if steps else None


# --------------------------------------------------------------- serving

# Interruption points of the serving engine (serve.engine fires them each
# step / admission). Deliberately a separate namespace from POINTS: the
# training matrices parametrize over POINTS and a serve point can never
# appear in a training Fault.
SERVE_POINTS = (
    "serve.decode.step",     # top of an engine step, before admission
    "serve.prefill.mid",     # prompt prefill computed, not yet committed
)


@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """One fault-injected *serving* experiment: a `ServeCluster` run
    under open-loop load with a single rank kill.

    The invariants are the serving analogue of `expect_bit_identical`:
    zero requests dropped, zero duplicate or re-emitted tokens (the
    TokenSink ledger raises on either), and — when
    `expect_bit_identical` — every request's delivered transcript
    bit-identical to the fault-free run of the same load. Kept jax-free
    like `Scenario`; the executor lives in repro.serve.cluster."""
    name: str
    strategy: str = "reinit"            # "reinit" | "replica"
    world: int = 2
    n_slots: int = 4
    max_len: int = 64
    rounds: int = 8                     # open-loop arrival horizon
    per_round: int = 1                  # arrivals per round (cluster-wide)
    max_new_tokens: int = 5
    seed: int = 0
    publish_every: int = 2              # replica forces 1 at run time
    respawn_delay: int = 2              # replica forces 0 at run time
    fault_round: int = 4
    fault_rank: int = 1
    fault_point: str = "serve.decode.step"
    expect_bit_identical: bool = True
    tags: tuple[str, ...] = ()
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "tags", tuple(self.tags))
        self.validate()

    def validate(self):
        if not self.name:
            raise ValueError("serve scenario needs a name")
        if self.strategy not in ("reinit", "replica"):
            raise ValueError(f"serve strategy {self.strategy!r} not in "
                             "('reinit', 'replica')")
        if self.fault_point not in SERVE_POINTS:
            raise ValueError(f"serve fault point {self.fault_point!r} "
                             f"not in {SERVE_POINTS}")
        if not (0 <= self.fault_rank < self.world):
            raise ValueError(f"victim rank {self.fault_rank} outside "
                             f"world {self.world}")
        if not (0 <= self.fault_round < self.rounds):
            raise ValueError(f"fault round {self.fault_round} outside "
                             f"load horizon [0, {self.rounds})")
        if self.world < 2:
            raise ValueError("serving fault tolerance needs world >= 2 "
                             "(the buddy holds the frames)")
        if min(self.n_slots, self.max_len, self.rounds, self.per_round,
               self.max_new_tokens, self.publish_every) < 1 \
                or self.respawn_delay < 0:
            raise ValueError(f"bad serve scenario sizes in {self.name}")

    def fault(self) -> dict:
        """The `fault=` argument `ServeCluster.run` takes."""
        return {"round": self.fault_round, "rank": self.fault_rank,
                "point": self.fault_point}

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tags"] = list(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServeScenario":
        d = dict(d)
        d["tags"] = tuple(d.get("tags", ()))
        return cls(**d)
