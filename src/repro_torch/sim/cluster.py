"""Discrete-event simulation of recovery timelines at 16–1024 ranks.

`simulate_run` replays one fault-injected execution of a proxy app under a
strategy. The recovery timeline is generated by running the *actual*
Algorithm-1/2 implementation (repro_torch.core.protocol) on the deployment tree
and charging each protocol event its calibrated cost — so the scaling
behaviour (flat CR/Reinit++, growing ULFM, Lustre-bound checkpoint writes)
emerges from the protocol structure, exactly the property the paper
measures in Figures 4–7.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.core.events import FailureEvent, FailureType
from repro_torch.core.protocol import ClusterView, root_handle_failure, \
    daemon_handle_reinit
from repro_torch.core.recovery import RecoveryStrategy, get_strategy
from repro_torch.checkpoint.policy import checkpoint_kind_for
from repro_torch.scenarios.schema import GRAY_DRAIN_PERSIST, GRAY_HOWS, \
    gray_delay_s, gray_drain_cut

from .costs import AppProfile, ClusterCosts

RANKS_PER_NODE = 16      # paper's deployment


@dataclasses.dataclass
class SimResult:
    app: str
    strategy: str
    n_ranks: int
    failure_kind: str
    # breakdown (seconds) — the paper's Figure-4 stacking
    ckpt_write_s: float
    mpi_recovery_s: float
    ckpt_read_s: float
    app_time_s: float
    lost_work_s: float
    detect_s: float

    @property
    def total_s(self) -> float:
        return (self.ckpt_write_s + self.mpi_recovery_s + self.ckpt_read_s
                + self.app_time_s + self.lost_work_s + self.detect_s)


def _mpi_recovery_time(strategy: RecoveryStrategy, failure: FailureEvent,
                       view: ClusterView, n_ranks: int,
                       costs: ClusterCosts, cmd=None,
                       ranks_per_node: int = RANKS_PER_NODE) -> float:
    """Timeline of the MPI-state recovery phase (no checkpoint I/O).
    `cmd` may carry a precomputed Algorithm-1 decision (the scenario
    executor runs the protocol itself to check its invariants); when
    None, Algorithm 1 runs here on the live view."""
    n_nodes = max(1, n_ranks // ranks_per_node)

    import math

    def spawn_time(n_procs: int) -> float:
        waves = math.ceil(n_procs / max(costs.spawn_parallelism, 1))
        return waves * costs.spawn_proc_s

    if strategy.replicates:                # -------------------- Replica
        # zero-rollback promote: no spawn, no rollback, no recompute.
        # (The scenario executor prices the no-shadow fallback separately
        # as a Reinit++ respawn.)
        n_promoted = ranks_per_node if failure.kind is FailureType.NODE \
            else 1
        return costs.promote_s(n_ranks, ranks_per_node, n_promoted)

    if strategy.redeploys:                      # ------------------- CR
        t = costs.teardown_s + costs.scheduler_redeploy_s
        # all nodes spawn their ranks in parallel; per node it's wave-wise
        t += spawn_time(ranks_per_node)
        t += costs.tree_barrier_s(n_ranks, ranks_per_node)   # MPI_Init
        return t

    # non-redeploy strategies run Algorithm 1 + 2 on the live tree
    if cmd is None:
        cmd = root_handle_failure(view, failure)
    per_daemon = {}
    for d in view.daemons():
        acts = daemon_handle_reinit(view, d, cmd)
        t_d = costs.signal_s * len(acts.signal_survivors)
        if acts.spawn:
            t_d += spawn_time(len(acts.spawn))
            if failure.kind is FailureType.NODE:
                t_d += costs.node_rehost_s       # wire-up on the new host
        per_daemon[d] = t_d
    slowest = max(per_daemon.values()) if per_daemon else 0.0

    if strategy.tree_broadcasts:     # Reinit++ (and the tree-broadcast
        # respawn path Shrink/Replica fall back to when they cannot
        # shrink/promote): REINIT broadcast over the root->daemon tree,
        # then the slowest daemon's local work, then the rejoin barrier.
        # No all-rank ops.
        import math
        bcast = costs.msg_latency_s * (1 + math.ceil(
            math.log2(max(n_nodes, 2))))
        return bcast + slowest + costs.tree_barrier_s(n_ranks,
                                                      RANKS_PER_NODE)

    # ---------------------------------------------------------- ULFM
    # revoke/shrink/agree/merge across all ranks + spawn of replacements
    t = costs.ulfm_recovery_collectives_s(n_ranks)
    t += slowest
    t += costs.tree_barrier_s(n_ranks, RANKS_PER_NODE)
    return t


def recovery_time(strategy_name: str, n_ranks: int, failure_kind: str,
                  costs: Optional[ClusterCosts] = None) -> dict:
    """MPI recovery time + detection, as plotted in Figures 6 and 7."""
    costs = costs or ClusterCosts()
    strategy = get_strategy(strategy_name)
    kind = FailureType.NODE if failure_kind == "node" else \
        FailureType.PROCESS
    n_nodes = max(1, n_ranks // RANKS_PER_NODE)
    view = ClusterView.build(n_nodes, RANKS_PER_NODE, spare_nodes=1)
    victim_rank = n_ranks // 2
    failure = FailureEvent(
        kind=kind,
        rank=victim_rank,
        node=view.parent(victim_rank) if kind is FailureType.NODE else None)

    if strategy.heartbeat is not None:
        detect = costs.heartbeat_detect_s
    elif kind is FailureType.NODE:
        detect = costs.channel_detect_s + costs.msg_latency_s
    else:
        detect = costs.sigchld_detect_s + 2 * costs.msg_latency_s
    mpi = _mpi_recovery_time(strategy, failure, view, n_ranks, costs)
    return {"detect_s": detect, "mpi_recovery_s": mpi}


def recovery_e2e(strategy_name: str, n_ranks: int, failure_kind: str,
                 read_s: float, *, pipelined: Optional[bool] = None,
                 costs: Optional[ClusterCosts] = None) -> dict:
    """End-to-end recovery = detect + MPI recovery + checkpoint restore,
    with the restore term measured on the real substrate (`read_s`).

    Two engine shapes:
      pipelined=False  the serialized legacy engine: polling detection
                       sleeps and drain timers sit on the path, and the
                       restore starts only after the respawn finishes.
      pipelined=True   the event-driven engine: no polling terms, and
                       survivors redistribute/restore state *while* the
                       replacement ranks spawn — the slower of the two
                       phases bounds the critical path.
    Defaults to the strategy's overlap_restore capability."""
    costs = costs or ClusterCosts()
    strategy = get_strategy(strategy_name)
    rec = recovery_time(strategy_name, n_ranks, failure_kind, costs)
    overlap = strategy.overlap_restore if pipelined is None else pipelined
    detect = rec["detect_s"]
    if overlap:
        total = detect + max(rec["mpi_recovery_s"], read_s)
    else:
        detect += costs.poll_respawn_s / 2      # expected polling wait
        total = detect + costs.poll_drain_s \
            + rec["mpi_recovery_s"] + read_s
    return {"detect_s": detect, "mpi_recovery_s": rec["mpi_recovery_s"],
            "read_s": read_s, "total_s": total, "pipelined": overlap}


# --------------------------------------------------------------- scenarios


@dataclasses.dataclass
class ScenarioSimResult:
    """One scenario replayed through the cost model over the real
    Algorithm-1/2 protocol. `rows` has one entry per injected fault,
    plus one per executed grow-back (elastic strategy only)."""
    scenario: str
    strategy: str
    n_ranks: int
    rows: list
    resume_steps: list               # one consensus per primary fault
                                     # (and per grow, elastic strategy)
    world_consistent: bool           # rank set == the *intended* world
                                     # after every recovery (shrinks and
                                     # grows only where the elastic
                                     # membership machine chose to)

    @property
    def resume_step(self) -> Optional[int]:
        return self.resume_steps[0] if self.resume_steps else None

    @property
    def total_recovery_s(self) -> float:
        # degraded_s is the gray rows' throughput tax: the whole cost of
        # a tolerated fault, and the detection-window cost of a drained
        # one — it belongs in the total either way
        return sum(r["detect_s"] + r["mpi_recovery_s"] + r["ckpt_read_s"]
                   + r.get("degraded_s", 0.0)
                   for r in self.rows)

    @property
    def n_recoveries(self) -> int:
        return len(self.rows)


def _scenario_failure(fault, view: ClusterView) -> FailureEvent:
    if fault.target == "node":
        return FailureEvent(kind=FailureType.NODE, rank=fault.rank,
                            node=view.parent(fault.rank),
                            at_step=fault.step)
    return FailureEvent(kind=FailureType.PROCESS, rank=fault.rank,
                        at_step=fault.step)


def _mech_resume(fault):
    """Modeled rollback consensus for one primary fault, derived from the
    failure *mechanics* — NOT from the schema's declarative oracle — so
    the test harness can cross-check the two derivations against each
    other. Survivors blocked at the fault's barrier have committed
    checkpoint `step`; the victim's replacement (or, for a shrink,
    nobody) re-gathers whatever was durable at the death point; the
    consensus is the min. Root faults return None (timing-dependent)."""
    if fault.target == "root":
        return None              # dies after a barrier release: cut is
                                 # timing-dependent (still consistent)
    if fault.point == "worker.ckpt.mid_write":
        victim_avail = fault.step - 1    # tmp bytes were never renamed
    else:
        victim_avail = fault.step        # fence-committed, or file
                                         # committed before the push died
    survivor_avail = fault.step          # committed behind fence/barrier
    return min(survivor_avail, victim_avail)


def _timeline(scenario) -> list:
    """Merged event order, as (index, what, obj): primary faults and
    node repairs by step (a step-N fault fires at the top of iteration
    N, a step-N repair at that step's checkpoint boundary, so faults
    sort first at a tie); cascade faults inherit their predecessor's
    step and follow it."""
    entries = []
    prev_step = 0
    for i, f in enumerate(scenario.faults):
        cascade = f.point.startswith("worker.recovery.")
        step = prev_step if cascade else f.step
        prev_step = step
        entries.append(((step if step is not None else 0, 0, i),
                        i, "cascade" if cascade else "fault", f))
    for i, r in enumerate(scenario.repairs):
        entries.append(((r.step, 1, i), i, "repair", r))
    entries.sort(key=lambda e: e[0])
    return [(i, what, obj) for _, i, what, obj in entries]


def _scenario_detect_s(fault, strategy, costs: ClusterCosts,
                       scenario) -> float:
    """Detection latency by failure mechanism — the matrix dimension the
    single `failure_kind` string could not express."""
    if strategy.heartbeat is not None:
        # the always-on heartbeat catches even silent ranks in one period
        return costs.heartbeat_detect_s
    if fault.target == "root":
        return costs.channel_detect_s            # daemons see the EOF
    if fault.how == "hang":
        if scenario.heartbeat_period_s > 0:
            if fault.target == "node":
                # daemon-level ring observation: the neighbour daemon
                # times the hung daemon out, reports SUSPECT_NODE, and
                # the root's kill breaks the channel (node-failure path)
                return scenario.heartbeat_timeout_s \
                    + scenario.heartbeat_period_s / 2 \
                    + costs.channel_detect_s + costs.msg_latency_s
            # neighbour-heartbeat ring: the observer times the successor
            # out after `timeout` of silence (expected half a period into
            # the window), reports SUSPECT, and the kill + SIGCHLD relay
            # runs like a process failure
            return scenario.heartbeat_timeout_s \
                + scenario.heartbeat_period_s / 2 \
                + costs.sigchld_detect_s + 2 * costs.msg_latency_s
        # nothing signals: the stall watchdog must time out, then the
        # kill + SIGCHLD relay runs like a process failure
        return scenario.stall_timeout_s + costs.sigchld_detect_s \
            + 2 * costs.msg_latency_s
    if fault.target == "node":
        return costs.channel_detect_s + costs.msg_latency_s
    return costs.sigchld_detect_s + 2 * costs.msg_latency_s


def simulate_scenario(scenario, strategy_name: str,
                      costs: Optional[ClusterCosts] = None,
                      ckpt_mb_per_rank: float = 1.0) -> ScenarioSimResult:
    """Drive one declarative Scenario through the simulator.

    The deployment tree comes from the scenario's topology; every event
    in the merged fault/repair timeline runs the *actual* protocol
    implementation on the evolving view (so cascading failures re-host
    against the post-first-recovery tree) and is charged its
    mechanism-specific detection + recovery + restore costs.

    Under the elastic strategy the `MembershipMachine` makes every
    decision — spare-absorbed respawn, shrink (node *or* single-rank
    losses, down to the `min_data_parallel` world floor), and grow-back
    on a node repair — and its invariants are checked after every
    transition. Non-elastic strategies preserve the world on every
    recovery and ignore repairs (their world never shrank). A cascade
    whose target rank is currently dropped from the world is deferred to
    the grow that re-admits it (its first chance to run again)."""
    from repro_torch.core.membership import MembershipMachine, MeshEpoch
    from repro_torch.core.protocol import apply_recovery

    costs = costs or ClusterCosts()
    strategy = get_strategy(strategy_name)
    topo = scenario.topology
    n_ranks = topo.world
    view = ClusterView.build(topo.nodes, topo.ranks_per_node, topo.spares)
    machine = MembershipMachine(
        view, MeshEpoch(epoch=0, data_parallel=topo.nodes,
                        model_parallel=topo.ranks_per_node),
        min_data_parallel=scenario.min_data_parallel) \
        if strategy.key in ("shrink", "replica") else None

    def _admit_shadows(m, v):
        """Replica deployment: every rank gets a warm shadow, hosted on
        the spare pool round-robin (off its own node by construction);
        with no spares, on the next compute node over."""
        spares = v.spares()
        for idx, r in enumerate(sorted(v.ranks())):
            home = v.parent(r)
            if spares:
                host = spares[idx % len(spares)]
            else:
                others = [d for d in v.daemons() if d != home]
                if not others:
                    continue           # single node: nowhere to shadow
                host = others[idx % len(others)]
            if host != home:
                m.admit_shadow(r, host)

    if strategy.replicates and machine is not None:
        _admit_shadows(machine, view)
    intended = set(view.ranks())       # the world each recovery must leave
    rows: list = []
    resumes: list = []                 # modeled consensus, event order
    drop_cuts: dict = {}               # dropped rank -> its shrink's cut
    consistent = True

    def charge_fault(i, fault, cascade):
        nonlocal view, machine, intended, consistent
        if fault.how in GRAY_HOWS:
            # gray failure: the rank degrades, nothing dies. BSP couples
            # the world to its slowest member, so the whole job pays the
            # victim's per-step delay for as long as it stays degraded.
            delay = gray_delay_s(fault)
            if not (scenario.mitigate and machine is not None
                    and strategy.key == "shrink"):
                # tolerated (mitigate=off, or a strategy that cannot
                # re-host): degraded to the end of the run; no failure,
                # no recovery, no consensus entry
                rows.append({
                    "fault": i, "target": fault.target, "how": fault.how,
                    "point": fault.point, "cascade": cascade,
                    "shrink": False, "grow": False, "promote": False,
                    "gray": True, "tolerated": True,
                    "detect_s": 0.0, "mpi_recovery_s": 0.0,
                    "ckpt_read_s": 0.0,
                    "degraded_s": max(0, scenario.steps - fault.step)
                    * delay,
                })
                return
            # mitigate=on: the straggler tracker needs GRAY_DRAIN_PERSIST
            # flagged barriers before the drain fires at a checkpoint
            # boundary — the job pays the delay only until then, and the
            # drain runs the ordinary shrink (drop the degraded rank or
            # node, survivors resume from the boundary's cut; a repair
            # grows it back healthy)
            detect = GRAY_DRAIN_PERSIST * delay + costs.msg_latency_s
            cut = gray_drain_cut(fault)
            failure = _scenario_failure(fault, view)
            cmd = machine.shrink(failure)
            for r in cmd.dropped:
                drop_cuts[r] = cut
            intended -= set(cmd.dropped)
            consistent &= set(view.ranks()) == intended
            rows.append({
                "fault": i, "target": fault.target, "how": fault.how,
                "point": fault.point, "cascade": cascade,
                "shrink": True, "grow": False, "promote": False,
                "gray": True, "tolerated": False,
                "detect_s": detect,
                "mpi_recovery_s": costs.shrink_recovery_s(
                    len(cmd.world), topo.ranks_per_node),
                "ckpt_read_s": 0.0,     # survivors keep local state
                "degraded_s": GRAY_DRAIN_PERSIST * delay,
            })
            resumes.append(cut)
            return
        detect = _scenario_detect_s(fault, strategy, costs, scenario)
        shrunk = False
        promoted = False
        if fault.target == "shadow":
            # the warm replica died, not the rank: the application never
            # notices. The root notes the lost cover (one registry
            # update) and the rank's next failure falls back to
            # global-restart — no consensus entry.
            if machine is not None and strategy.replicates:
                machine.shadow_lost(fault.rank)
            rows.append({
                "fault": i, "target": fault.target, "how": fault.how,
                "point": fault.point, "cascade": cascade, "shrink": False,
                "grow": False, "promote": False,
                "detect_s": detect, "mpi_recovery_s": costs.msg_latency_s,
                "ckpt_read_s": 0.0,
            })
            return
        if strategy.replicates and fault.target == "root":
            # warm-standby takeover: daemons re-home, the mirrored tables
            # reconcile, nobody restarts and nothing is re-read
            mpi = costs.standby_takeover_s(n_ranks, topo.ranks_per_node)
            promoted = True
            readers = 0
        elif strategy.redeploys or fault.target == "root":
            # CR (or loss of the root itself): full teardown + re-deploy;
            # the tree is rebuilt, every rank restarts from file
            mpi = _mpi_recovery_time(
                get_strategy("cr"), None, view, n_ranks, costs,
                ranks_per_node=topo.ranks_per_node)
            view = ClusterView.build(topo.nodes, topo.ranks_per_node,
                                     topo.spares)
            if machine is not None:
                machine = MembershipMachine(
                    view, MeshEpoch(epoch=0, data_parallel=topo.nodes,
                                    model_parallel=topo.ranks_per_node),
                    min_data_parallel=scenario.min_data_parallel)
            intended = set(view.ranks())
            readers = None                       # every rank re-reads
        else:
            failure = _scenario_failure(fault, view)
            if strategy.replicates and machine is not None \
                    and fault.point == "step" \
                    and machine.can_promote(failure):
                # zero-rollback failover: the warm shadow's newest frame
                # is the survivors' cut (a fence/step-boundary failure),
                # so it takes over in place. Faults at checkpoint-write
                # or cascade points leave the shadow behind the cut and
                # fall through to the Reinit++ respawn fallback below.
                cmd = machine.promote(failure)
                consistent &= set(view.ranks()) == intended
                promoted = True
                mpi = costs.promote_s(n_ranks, topo.ranks_per_node,
                                      len(cmd.promotions))
                readers = 0
            elif machine is not None and strategy.key == "shrink" \
                    and not cascade \
                    and machine.decide(failure) == "shrink":
                # elastic path, pool exhausted: drop the lost ranks (a
                # node's group, or a single rank leaving uneven groups)
                cmd = machine.shrink(failure)
                for r in cmd.dropped:
                    drop_cuts[r] = _mech_resume(fault)
                intended -= set(cmd.dropped)
                consistent &= set(view.ranks()) == intended
                shrunk = True
                mpi = costs.shrink_recovery_s(len(cmd.world),
                                              topo.ranks_per_node)
                readers = 0      # survivors restore from local memory
            else:
                # cascades always merge into the in-flight recovery via
                # respawn — a second failure never shrinks on its own
                if machine is not None:
                    cmd = machine.respawn(failure)
                else:
                    cmd = root_handle_failure(view, failure)
                states = apply_recovery(view, cmd)
                consistent &= set(view.ranks()) == intended \
                    and set(states) == intended
                # a replica fallback (no warm shadow at the cut) is
                # priced as the Reinit++ respawn it actually performs
                price = get_strategy("reinit") if strategy.replicates \
                    else strategy
                mpi = _mpi_recovery_time(price, failure, view, n_ranks,
                                         costs, cmd=cmd,
                                         ranks_per_node=topo.ranks_per_node)
                readers = topo.ranks_per_node    # only re-hosted ranks read
        kind = "node" if fault.target == "node" else "process"
        # promoted recoveries never read a checkpoint — the warm compose
        # is already inside promote_s; a replica *fallback* restores the
        # way the Reinit++ respawn it degrades to would
        ckpt_key = "reinit" if (strategy.replicates and not promoted) \
            else strategy.key
        if promoted:
            read = 0.0
        elif shrunk or (fault.target != "root" and
                        checkpoint_kind_for(kind, ckpt_key) == "memory"):
            read = ckpt_mb_per_rank / costs.nic_bw_MBps
        else:
            read = costs.file_read_s(n_ranks, ckpt_mb_per_rank, readers)
        rows.append({
            "fault": i, "target": fault.target, "how": fault.how,
            "point": fault.point, "cascade": cascade, "shrink": shrunk,
            "grow": False, "promote": promoted,
            "detect_s": detect, "mpi_recovery_s": mpi, "ckpt_read_s": read,
        })
        if not cascade:
            resumes.append(_mech_resume(fault))

    def charge_repair(i, repair):
        nonlocal intended, consistent
        if machine is None:
            return                  # non-elastic: the world never shrank
        node = f"node{repair.rank // topo.ranks_per_node}"
        if node in view.children:
            return                  # node never left the world: no-op
        if machine.admit(node) == "spare":
            machine.grant_spare(node)    # nothing dropped: joins the pool
            return
        cmd = machine.grow(node)
        intended |= set(cmd.added)
        consistent &= set(view.ranks()) == intended
        mpi = costs.grow_recovery_s(len(cmd.world), topo.ranks_per_node,
                                    len(cmd.added))
        # re-admitted ranks re-read their pinned files; survivors keep
        # local state (Table-2 "grow" scheme)
        if checkpoint_kind_for("grow", strategy.key) == "file":
            read = costs.file_read_s(n_ranks, ckpt_mb_per_rank,
                                     len(cmd.added))
        else:
            read = ckpt_mb_per_rank / costs.nic_bw_MBps
        rows.append({
            "repair": i, "target": "repair", "how": "rejoin",
            "point": "rejoin", "cascade": False, "shrink": False,
            "grow": True, "added": sorted(cmd.added),
            "mesh_epoch": cmd.mesh_epoch,
            "detect_s": costs.msg_latency_s,   # REJOIN registration hop
            "mpi_recovery_s": mpi, "ckpt_read_s": read,
        })
        # the grow consensus lands on the re-admitted ranks' newest
        # durable state: the cut of the shrink that dropped them
        resumes.append(min(drop_cuts.pop(r) for r in cmd.added))

    pending: list = []             # cascades whose rank is dropped

    def drain_pending():
        for entry in list(pending):
            i, fault = entry
            if fault.target != "rank" or fault.rank in set(view.ranks()):
                pending.remove(entry)
                charge_fault(i, fault, cascade=True)

    for i, what, obj in _timeline(scenario):
        if what == "cascade":
            if obj.target == "rank" and obj.rank not in set(view.ranks()):
                pending.append((i, obj))   # fires at the re-admitting grow
            else:
                charge_fault(i, obj, cascade=True)
        elif what == "fault":
            charge_fault(i, obj, cascade=False)
            drain_pending()
        else:
            charge_repair(i, obj)
            drain_pending()
    if machine is not None:
        machine.check_invariants()

    return ScenarioSimResult(
        scenario=scenario.name, strategy=strategy.key, n_ranks=n_ranks,
        rows=rows, resume_steps=resumes,
        world_consistent=consistent)


def replica_break_even(app: AppProfile, n_ranks: int,
                       failure_kind: str = "process",
                       costs: Optional[ClusterCosts] = None) -> dict:
    """The replica-vs-reinit break-even oracle.

    Replica pays a fault-free tax every step (the extra delta-frame push
    to the shadow) and gets it back on every failure (promote instead of
    respawn + restore). The oracle reports both sides and the number of
    failures per run above which replica is the cheaper strategy — below
    one failure per run, the tax never amortizes and reinit wins."""
    costs = costs or ClusterCosts()
    replica = get_strategy("replica")
    reinit = get_strategy("reinit")
    tax_per_step = replica.fault_free_overhead(
        n_ranks, stream_mb_per_rank=app.ckpt_mb_per_rank,
        nic_bw_MBps=costs.nic_bw_MBps) - reinit.fault_free_overhead(n_ranks)
    tax_per_run = tax_per_step * app.n_steps

    def e2e(name: str) -> float:
        rec = recovery_time(name, n_ranks, failure_kind, costs)
        read = 0.0 if name == "replica" else \
            app.ckpt_mb_per_rank / costs.nic_bw_MBps \
            if checkpoint_kind_for(failure_kind, name) == "memory" else \
            costs.file_read_s(n_ranks, app.ckpt_mb_per_rank,
                              RANKS_PER_NODE)
        return rec["detect_s"] + rec["mpi_recovery_s"] + read

    saving = e2e("reinit") - e2e("replica")
    return {
        "tax_per_step_s": tax_per_step,
        "tax_per_run_s": tax_per_run,
        "saving_per_failure_s": saving,
        "break_even_failures": float("inf") if saving <= 0
        else tax_per_run / saving,
    }


def rehost_break_even(app: AppProfile, n_ranks: int, slow_factor: float,
                      fail_step: Optional[int] = None,
                      repair_after: Optional[int] = None,
                      costs: Optional[ClusterCosts] = None) -> dict:
    """The tolerate-vs-rehost oracle for gray failures.

    Tolerating a rank decelerated by `slow_factor` taxes EVERY remaining
    step (BSP couples the job to its slowest member — see
    ClusterCosts.degraded_step_s); draining and re-hosting pays the
    detection window at degraded pace, one shrink recovery, a shrunk-
    world throughput penalty until the node is repaired (grow-back +
    pinned-file restore), or to the end of the run when it never is.
    Reports both sides and the deceleration factor above which
    re-hosting wins — mild degradation is cheaper to tolerate, severe
    degradation is cheaper to drain, and the crossover moves with how
    long the run still has to go."""
    costs = costs or ClusterCosts()
    s = app.step_time_s
    if fail_step is None:
        fail_step = app.n_steps // 4
    remaining = max(app.n_steps - fail_step, GRAY_DRAIN_PERSIST + 1)
    tax_per_step = costs.degraded_step_s(s, slow_factor) - s
    tolerate = remaining * tax_per_step

    detect_steps = GRAY_DRAIN_PERSIST       # flagged barriers before drain
    shrunk_steps = remaining - detect_steps if repair_after is None \
        else min(repair_after, remaining - detect_steps)
    # one rank of n dropped: survivors re-balance its share every step
    shrunk_penalty = shrunk_steps * s * (n_ranks / (n_ranks - 1) - 1.0)
    fixed = costs.shrink_recovery_s(n_ranks - 1, RANKS_PER_NODE) \
        + shrunk_penalty
    if repair_after is not None \
            and repair_after < remaining - detect_steps:
        fixed += costs.grow_recovery_s(n_ranks, RANKS_PER_NODE, 1) \
            + costs.file_read_s(n_ranks, app.ckpt_mb_per_rank, 1)
    rehost = detect_steps * tax_per_step + fixed
    denom = (remaining - detect_steps) * s
    return {
        "tolerate_extra_s": tolerate,
        "rehost_extra_s": rehost,
        "rehost_wins": rehost < tolerate,
        "break_even_factor": float("inf") if denom <= 0
        else 1.0 + fixed / denom,
    }


def simulate_run(app: AppProfile, n_ranks: int, strategy_name: str,
                 failure_kind: str = "process",
                 costs: Optional[ClusterCosts] = None,
                 seed: int = 0) -> SimResult:
    """One fault-injected execution (single failure, like the paper)."""
    costs = costs or ClusterCosts()
    strategy = get_strategy(strategy_name)
    rng = random.Random(seed)
    fail_step = rng.randint(app.n_steps // 4, (3 * app.n_steps) // 4)

    ckpt_kind = checkpoint_kind_for(failure_kind, strategy.key)
    # CR must *always* write file checkpoints during fault-free execution;
    # ULFM/Reinit++ write memory checkpoints for process-failure coverage
    # but also file for node coverage — the paper's Table 2 charges each
    # experiment only its scheme's cost.
    if strategy.key == "cr" or ckpt_kind == "file":
        write_each = costs.file_write_s(n_ranks, app.ckpt_mb_per_rank)
    else:
        write_each = costs.mem_ckpt_s(app.ckpt_mb_per_rank)
    ckpt_write_s = write_each * app.n_steps

    # pure application time + per-step fault-free overhead (ULFM's
    # heartbeat; Replica's extra delta-frame push to the shadow)
    step = app.step_time_s + strategy.fault_free_overhead(
        n_ranks, stream_mb_per_rank=app.ckpt_mb_per_rank,
        nic_bw_MBps=costs.nic_bw_MBps)
    app_time_s = step * app.n_steps
    lost_work_s = 0.0      # ckpt every step: only the partial step is lost
    rec = recovery_time(strategy_name, n_ranks, failure_kind, costs)

    if ckpt_kind == "file":
        if strategy.redeploys:
            readers = None                       # every rank re-reads
        else:
            readers = RANKS_PER_NODE             # only the re-hosted node
        ckpt_read_s = costs.file_read_s(n_ranks, app.ckpt_mb_per_rank,
                                        readers)
    else:
        ckpt_read_s = app.ckpt_mb_per_rank / costs.nic_bw_MBps

    return SimResult(
        app=app.name, strategy=strategy.name, n_ranks=n_ranks,
        failure_kind=failure_kind, ckpt_write_s=ckpt_write_s,
        mpi_recovery_s=rec["mpi_recovery_s"], ckpt_read_s=ckpt_read_s,
        app_time_s=app_time_s, lost_work_s=lost_work_s,
        detect_s=rec["detect_s"])
