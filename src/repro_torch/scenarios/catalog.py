"""The scenario catalog: every failure shape we assert recovery against.

The PyTorch port's own copy of the JAX package's catalog (stdlib only),
entry for entry. Each entry is one reproducible experiment (see
schema.Scenario / schema.ServeScenario); the serving cells drive
`repro_torch.serve.cluster`. The breadth mirrors the related work:
ReStore's failures-during-recovery-and-replication, and
Shrink-or-Substitute's failure-mode x strategy matrix.

Tags:
  fast    the subset the default test run / CI `scenario_fast` job
          executes on the real runtime (the full matrix is `scenario_slow`)
  slow3   3-node topologies — opt-in in CI (ROADMAP: scale the real
          runtime past 2 nodes)
"""
from __future__ import annotations

from .schema import Fault, Repair, Scenario, ServeScenario, Topology

T22 = Topology(nodes=2, ranks_per_node=2, spares=1)      # world 4
T22S0 = Topology(nodes=2, ranks_per_node=2, spares=0)    # world 4, no pool
T32 = Topology(nodes=3, ranks_per_node=2, spares=1)      # world 6
T32S2 = Topology(nodes=3, ranks_per_node=2, spares=2)    # world 6, deep pool

CATALOG: tuple[Scenario, ...] = (
    # ------------------------------------------------ process failures
    Scenario(
        name="proc-sigkill-midstep",
        description="The paper's §4 baseline: SIGKILL one rank behind the "
                    "FENCE at mid-run.",
        topology=T22, faults=(Fault("rank", 1, 3),),
        strategies=("reinit", "cr", "ulfm")),
    Scenario(
        name="proc-sigkill-rank0",
        description="Victim is rank 0 — exercises the buddy-ring wrap "
                    "(rank 0 restores from rank 1, world-1 pushes to 0).",
        topology=T22, faults=(Fault("rank", 0, 2),),
        strategies=("reinit", "cr")),
    Scenario(
        name="proc-sigkill-early",
        description="Failure at the first fence-able step: only one "
                    "checkpoint exists anywhere.",
        topology=T22, faults=(Fault("rank", 3, 1),),
        strategies=("reinit", "cr", "ulfm")),
    Scenario(
        name="proc-sigkill-late",
        description="Failure at the second-to-last step: recovery, one "
                    "step, then straight into shutdown.",
        topology=T22, faults=(Fault("rank", 2, 4),),
        strategies=("reinit", "cr")),
    # --------------------------------------------------- node failures
    Scenario(
        name="node-sigkill",
        description="Whole-node loss (daemon + children): ranks re-hosted "
                    "on the least-loaded node, restore from file tier.",
        topology=T22, faults=(Fault("node", 1, 3),),
        strategies=("reinit", "cr", "ulfm")),
    Scenario(
        name="node-sigkill-late",
        description="Node loss on the other node, late in the run.",
        topology=T22, faults=(Fault("node", 3, 4),),
        strategies=("reinit", "cr")),
    # ------------------------------------- silent / partition failures
    Scenario(
        name="proc-hang",
        description="Rank goes silent (no SIGCHLD, channel intact): only "
                    "the root's stall watchdog can detect it, then kills "
                    "and recovers it like a process failure.",
        topology=T22, faults=(Fault("rank", 1, 3, how="hang"),),
        stall_timeout_s=6.0,
        strategies=("reinit", "cr", "ulfm")),
    Scenario(
        name="proc-hang-heartbeat",
        description="Rank goes silent with the stall watchdog DISARMED: "
                    "only the neighbour-heartbeat ring (each rank observes "
                    "its ring successor, SUSPECT to root on timeout) "
                    "detects it — hang cells measure detection latency "
                    "instead of charging the watchdog.",
        topology=T22, faults=(Fault("rank", 1, 3, how="hang"),),
        heartbeat_period_s=0.2, heartbeat_timeout_s=1.0,
        strategies=("reinit", "ulfm"), tags=("fast",)),
    Scenario(
        name="proc-channel-break",
        description="Rank's control channel to its daemon breaks; the "
                    "fail-stop rank fences itself and dies, detection via "
                    "the EOF/SIGCHLD path.",
        topology=T22, faults=(Fault("rank", 1, 3, how="channel_break"),),
        strategies=("reinit", "cr")),
    Scenario(
        name="node-channel-break",
        description="Daemon-root channel breaks (network partition): the "
                    "partitioned node self-fences, root sees a node loss "
                    "via channel EOF instead of silence.",
        topology=T22,
        faults=(Fault("node", 2, 3, how="channel_break"),),
        strategies=("reinit", "cr"), tags=("fast",)),
    # --------------------------------- failures inside the ckpt machinery
    Scenario(
        name="ckpt-midwrite-kill",
        description="SIGKILL between the tmp shard write and the atomic "
                    "rename: the in-flight checkpoint must be invisible "
                    "and the consensus lands one step back.",
        topology=T22,
        faults=(Fault("rank", 1, 3, point="worker.ckpt.mid_write"),),
        strategies=("reinit", "cr"), tags=("fast",)),
    Scenario(
        name="ckpt-prepush-kill",
        description="ReStore's mid-replication failure: the file commit "
                    "landed but the buddy copy was never pushed; the "
                    "merged buddy+file restore still reaches the step.",
        topology=T22,
        faults=(Fault("rank", 1, 3, point="worker.ckpt.pre_push"),),
        strategies=("reinit", "cr"), tags=("fast",)),
    # ------------------------------------ failures during recovery itself
    Scenario(
        name="cascade-respawn-dies",
        description="The re-spawned replacement dies again right after "
                    "pulling its frames — recovery of the recovery.",
        topology=T22,
        faults=(Fault("rank", 1, 3),
                Fault("rank", 1, None, point="worker.recovery.pulled")),
        strategies=("reinit",), tags=("fast",)),
    Scenario(
        name="cascade-survivor-dies",
        description="A survivor dies immediately after its SIGREINIT "
                    "rollback, while the first recovery is still in "
                    "flight — the recoveries must merge.",
        topology=T22,
        faults=(Fault("rank", 1, 3),
                Fault("rank", 2, None, point="worker.recovery.enter")),
        strategies=("reinit",)),
    Scenario(
        name="cascade-compose-kill",
        description="Kill mid delta-chain compose of the restore: the "
                    "next incarnation re-pulls and re-composes the same "
                    "frames.",
        topology=T22,
        faults=(Fault("rank", 1, 3),
                Fault("rank", 1, None, point="worker.recovery.compose")),
        strategies=("reinit",)),
    # ------------------------------------- elastic / shrinking recovery
    Scenario(
        name="double-node-loss",
        description="Two sequential whole-node losses absorbed by a "
                    "two-deep spare pool: Algorithm 1's least-loaded "
                    "choice re-hosts each onto a fresh spare and the "
                    "world never shrinks (the paper's §3.2 deployment "
                    "model at its provisioning limit).",
        topology=T32S2,
        faults=(Fault("node", 2, 2), Fault("node", 4, 4)),
        strategies=("reinit", "cr", "ulfm", "shrink"), tags=("fast",)),
    Scenario(
        name="spare-pool-exhaustion",
        description="Node losses outnumber the spare pool: the second "
                    "loss finds it empty. Elastic recovery shrinks the "
                    "world (survivors re-balance over a contracted data "
                    "axis, bumped mesh epoch); non-elastic strategies "
                    "over-subscribe a surviving host.",
        topology=T32,
        faults=(Fault("node", 2, 2), Fault("node", 4, 4)),
        strategies=("shrink", "reinit", "cr", "ulfm"),
        expect_bit_identical=False,      # a shrunk world sums fewer ranks
        tags=("fast",)),
    Scenario(
        name="proc-loss-shrink",
        description="Process-level shrink: a single-rank loss with the "
                    "spare pool empty drops that rank instead of "
                    "respawning — the surviving groups are uneven (one "
                    "node keeps 2 ranks, the victim's keeps 1) and the "
                    "world stays above the min_data_parallel floor. "
                    "Non-elastic strategies respawn in place.",
        topology=T22S0, faults=(Fault("rank", 1, 3),),
        strategies=("shrink", "reinit", "cr", "ulfm"),
        expect_bit_identical=False,      # a shrunk world sums fewer ranks
        tags=("fast",)),
    Scenario(
        name="shrink-then-growback",
        description="The full elastic lifecycle: a node loss with no "
                    "spares shrinks the world 4->2 (survivors pin the "
                    "cut); the repaired node's daemon re-registers at a "
                    "later checkpoint boundary (REJOIN) and the root "
                    "grows the world back 2->4 (GROW broadcast, bumped "
                    "mesh epoch) — the consensus lands on the pinned "
                    "pre-shrink cut and the re-expanded run finishes "
                    "bit-identically to fault-free.",
        topology=T22S0, steps=7,
        faults=(Fault("node", 2, 2),),
        repairs=(Repair(2, 4),),
        strategies=("shrink", "reinit", "cr", "ulfm"),
        tags=("fast",)),
    Scenario(
        name="growback-mid-cascade",
        description="A cascading failure during the grow-back itself: "
                    "one of the re-admitted ranks dies again right after "
                    "pulling its frames — the cascade merges into the "
                    "in-flight grow recovery and the world still ends "
                    "re-expanded and bit-identical.",
        topology=T22S0, steps=7,
        faults=(Fault("node", 2, 2),
                Fault("rank", 2, None, point="worker.recovery.pulled")),
        repairs=(Repair(2, 4),),
        strategies=("shrink", "reinit"), tags=("fast",)),
    Scenario(
        name="shrink-then-growback-3node",
        description="3-node lifecycle: the first node loss is absorbed "
                    "by the spare, the second shrinks 6->4, then the "
                    "repaired node rejoins and the world grows back to "
                    "6 at a checkpoint boundary.",
        topology=T32, steps=9,
        faults=(Fault("node", 2, 2), Fault("node", 4, 4)),
        repairs=(Repair(4, 6),),
        strategies=("shrink", "reinit", "cr", "ulfm"),
        tags=("slow3",)),
    Scenario(
        name="node-hang-heartbeat",
        description="The whole node goes silent (hung daemon: children "
                    "muted, control channel open, nothing relayed): only "
                    "the daemon-level heartbeat ring can see it — the "
                    "observer daemon SUSPECT_NODEs its successor, the "
                    "root kills the hung daemon and the channel EOF "
                    "drives the ordinary node-failure path.",
        topology=T22, faults=(Fault("node", 2, 3, how="hang"),),
        heartbeat_period_s=0.25, heartbeat_timeout_s=1.0,
        strategies=("reinit", "ulfm"), tags=("fast",)),
    Scenario(
        name="shrink-after-cascade",
        description="The first node recovery suffers a cascading "
                    "replacement death (ReStore's failure-during-"
                    "recovery); a later node loss then exhausts the "
                    "pool and the elastic path shrinks instead of "
                    "aborting.",
        topology=T32,
        faults=(Fault("node", 2, 2),
                Fault("rank", 2, None, point="worker.recovery.pulled"),
                Fault("node", 4, 4)),
        strategies=("shrink",),
        expect_bit_identical=False),
    # --------------------------------------- replica (zero-rollback) cells
    Scenario(
        name="replica-promote",
        description="Zero-rollback failover: rank 1 dies behind the FENCE "
                    "at step 3; its warm shadow (fed the buddy delta "
                    "stream every step) is promoted in place, completes "
                    "the stalled barrier, and the run resumes AT step 3 "
                    "with no rollback, no respawn and no recomputed "
                    "steps — bit-identical to fault-free.",
        topology=T22, faults=(Fault("rank", 1, 3),),
        strategies=("replica", "reinit"), tags=("fast",)),
    Scenario(
        name="replica-shadow-loss",
        description="The shadow dies, not the rank: the application never "
                    "notices (no consensus entry), rank 1 silently loses "
                    "its zero-rollback cover, and its later failure "
                    "falls back to global-restart recovery.",
        topology=T22,
        faults=(Fault("shadow", 1, 2), Fault("rank", 1, 4)),
        strategies=("replica",), tags=("fast",)),
    Scenario(
        name="replica-promote-cascade",
        description="Failure during the promotion window: the shadow "
                    "dies right as it is being promoted — the root must "
                    "merge the loss into the in-flight recovery (fall "
                    "back to respawn), never deadlock or double-promote.",
        topology=T22,
        faults=(Fault("rank", 1, 3),
                Fault("rank", 1, None, point="worker.recovery.pulled")),
        strategies=("replica",), tags=("fast",)),
    Scenario(
        name="replica-root-loss-standby",
        description="Root loss under replica: the warm standby (mirroring "
                    "the rank/daemon/membership tables over the "
                    "replication channel) takes over, daemons re-home to "
                    "it, and the job finishes with NO external relaunch "
                    "— the last single point of failure removed.",
        topology=T22, faults=(Fault("root", step=3),),
        strategies=("replica",), tags=()),
    Scenario(
        name="replica-3node-cascade",
        description="3-node replica matrix: a promote at step 2, then a "
                    "second rank loss at step 4 on another node — two "
                    "independent zero-rollback failovers in one run.",
        topology=T32,
        faults=(Fault("rank", 1, 2), Fault("rank", 4, 4)),
        strategies=("replica", "reinit"), tags=("slow3",)),
    # --------------------------------------- gray (degraded) failures
    Scenario(
        name="slow-rank-tolerate",
        description="Gray baseline: rank 1 decelerates x6 from step 3 "
                    "(injected per-step delay) but nothing dies. With "
                    "mitigate=False the policy is to tolerate: no "
                    "recovery fires, the whole BSP job just runs at the "
                    "straggler's pace and finishes bit-identical to "
                    "fault-free.",
        topology=T22,
        faults=(Fault("rank", 1, 3, how="slow", factor=6.0),),
        strategies=("reinit", "shrink", "cr", "ulfm"),
        tags=("fast", "gray")),
    Scenario(
        name="slow-rank-drain",
        description="Mitigated straggler: the root's per-rank lateness "
                    "tracker flags rank 1's sustained x6 slowdown and "
                    "drains it once the lateness persists — an ordinary "
                    "process-level shrink at the withheld barrier's cut "
                    "(pool empty), survivors re-balance and resume "
                    "bit-identically from the drain cut.",
        topology=T22S0, steps=7,
        faults=(Fault("rank", 1, 3, how="slow", factor=6.0),),
        mitigate=True, strategies=("shrink",),
        expect_bit_identical=False,      # a shrunk world sums fewer ranks
        tags=("fast", "gray")),
    Scenario(
        name="slow-node-drain-growback",
        description="Sick-host lifecycle: every rank on node1 runs x6 "
                    "slow from step 3 (degradation is per-host); the "
                    "root drains the whole node through SHRINK, and the "
                    "repaired (healthy again) node REJOINs at step 6 — "
                    "the grow-back re-admits it and the re-expanded run "
                    "finishes bit-identical to fault-free.",
        topology=T22S0, steps=8,
        faults=(Fault("node", 2, 3, how="slow", factor=6.0),),
        repairs=(Repair(2, 6),),
        mitigate=True, strategies=("shrink",),
        tags=("fast", "gray")),
    Scenario(
        name="lossy-rank-tolerate",
        description="Degraded link, tolerated: rank 1's control-channel "
                    "sends pay a seeded delay/retransmit tax from step 3 "
                    "(the transport layer's lossy injection). Barriers "
                    "arrive late but complete; no recovery fires and the "
                    "run finishes bit-identical.",
        topology=T22,
        faults=(Fault("rank", 1, 3, how="lossy", factor=6.0),),
        strategies=("reinit", "shrink", "cr", "ulfm"),
        tags=("fast", "gray")),
    Scenario(
        name="lossy-rank-drain",
        description="Degraded link, drained: the same lossy injection "
                    "with mitigation on — transport lateness is "
                    "indistinguishable from compute lateness at the "
                    "barrier, so the same tracker flags it and the same "
                    "shrink path drains the rank at the withheld cut.",
        topology=T22S0, steps=7,
        faults=(Fault("rank", 1, 3, how="lossy", factor=6.0),),
        mitigate=True, strategies=("shrink",),
        expect_bit_identical=False,      # a shrunk world sums fewer ranks
        tags=("fast", "gray")),
    # ------------------------------------------------- flapping nodes
    Scenario(
        name="flap-node-twice",
        description="A flapping node: node1 dies at step 2, its repair "
                    "rejoins (GROW) at step 4, the same node dies AGAIN "
                    "at step 5 and rejoins at step 7 — two full "
                    "shrink->grow round-trips in one run, each landing "
                    "on its own pinned cut, finishing bit-identical "
                    "with the full world.",
        topology=T22S0, steps=9,
        faults=(Fault("node", 2, 2), Fault("node", 2, 5)),
        repairs=(Repair(2, 4), Repair(2, 7)),
        strategies=("shrink",), tags=("fast", "flap")),
    Scenario(
        name="flap-refail-in-rejoin",
        description="Fail during the open rejoin consensus: node1 dies "
                    "and is dropped; its repair rejoins, and one of the "
                    "re-admitted ranks dies again right after pulling "
                    "its frames — while the grow's JOIN window is still "
                    "open. The root must merge the death into the "
                    "in-flight grow recovery (respawn within the same "
                    "consensus), never deadlock the held barrier.",
        topology=T22S0, steps=7,
        faults=(Fault("node", 2, 2),
                Fault("rank", 3, None, point="worker.recovery.pulled")),
        repairs=(Repair(2, 4),),
        strategies=("shrink",), tags=("fast", "flap")),
    # -------------------------------------------------------- root loss
    Scenario(
        name="root-restart",
        description="The HNP itself dies (Reinit++'s single point of "
                    "failure): only external job restart recovers; the "
                    "resume step is timing-dependent but the state is "
                    "still bit-identical.",
        topology=T22, faults=(Fault("root", step=3),),
        strategies=("cr",)),
    # ---------------------------------------------- 3-node topologies
    Scenario(
        name="three-node-node-kill",
        description="Node loss in a 3-node/6-rank tree: re-host on the "
                    "least-loaded of two surviving nodes (+spare).",
        topology=T32, faults=(Fault("node", 2, 3),),
        strategies=("reinit", "cr"), tags=("slow3",)),
    Scenario(
        name="three-node-cascade",
        description="6-rank tree, replacement dies again mid-restore.",
        topology=T32,
        faults=(Fault("rank", 4, 3),
                Fault("rank", 4, None, point="worker.recovery.pulled")),
        strategies=("reinit",), tags=("slow3",)),
)

BY_NAME = {s.name: s for s in CATALOG}


def get_scenario(name: str) -> Scenario:
    try:
        return BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(BY_NAME)}") from None


def fault_free(topology: Topology, steps: int = 6, dim: int = 64
               ) -> Scenario:
    """The reference run every expect_bit_identical scenario is compared
    against — same topology/steps/dim, zero faults."""
    return Scenario(name=f"fault-free-{topology.nodes}x"
                         f"{topology.ranks_per_node}",
                    faults=(), topology=topology, steps=steps, dim=dim,
                    strategies=("reinit",))


# ------------------------------------------------------- serving catalog
#
# Serving cells kill a rank of a live ServeCluster (serve.cluster)
# under sustained open-loop load and assert the serving invariants: zero
# requests dropped, zero duplicate/lost tokens, transcripts bit-identical
# to the fault-free run. They live in their own catalog — the training
# matrices in tests/test_scenarios.py parametrize over CATALOG and must
# not pick these up.

SERVE_CATALOG: tuple[ServeScenario, ...] = (
    ServeScenario(
        name="serve-rank-loss",
        description="The serving baseline: SIGKILL-equivalent loss of a "
                    "decoding rank mid-stream under open-loop load; the "
                    "respawned rank composes its buddy's held delta "
                    "frames, replays with emission suppressed, and every "
                    "client transcript finishes bit-identical with zero "
                    "re-delivered tokens.",
        strategy="reinit", fault_point="serve.decode.step",
        fault_round=4, fault_rank=1, tags=("fast",)),
    ServeScenario(
        name="serve-mid-prefill",
        description="Kill between a prompt batch's prefill compute and "
                    "its commit: the queued requests were never admitted, "
                    "so the snapshot replays them from the queue — only "
                    "computed work is lost, never a request.",
        strategy="reinit", fault_point="serve.prefill.mid",
        fault_round=4, fault_rank=1, tags=("fast",)),
    ServeScenario(
        name="serve-replica-promote",
        description="Zero-rollback serving failover: the buddy applies "
                    "every per-step frame into a warm standby snapshot; "
                    "promotion restores it immediately with nothing to "
                    "compose, so the first recovered token arrives a "
                    "fraction of reinit's gap after the kill.",
        strategy="replica", fault_point="serve.decode.step",
        fault_round=4, fault_rank=1, tags=("fast",)),
    ServeScenario(
        name="serve-rank-loss-wide",
        description="High-slot-count variant of serve-rank-loss: a wide "
                    "slot pool under heavier load (nightly; the fast job "
                    "runs the small cells).",
        strategy="reinit", fault_point="serve.decode.step",
        n_slots=16, rounds=10, per_round=3, fault_round=5, fault_rank=1,
        tags=("nightly",)),
)

SERVE_BY_NAME = {s.name: s for s in SERVE_CATALOG}


def get_serve_scenario(name: str) -> ServeScenario:
    try:
        return SERVE_BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown serve scenario {name!r}; "
                       f"known: {sorted(SERVE_BY_NAME)}") from None
