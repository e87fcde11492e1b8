"""Calibrated α–β cost model for the cluster simulator.

Constants come from two sources, and EXPERIMENTS.md reports which is which:
  (a) measured on this machine's real-process runtime (spawn cost, detect
      latency, control-message latency), and
  (b) the paper's absolute numbers at known scales (CR ≈ 3 s re-deploy,
      Reinit++ ≈ 0.5 s process / 1.5 s node, ULFM ≈ 3× Reinit++ at 1024
      ranks, Lustre-bound checkpoint writes) — used to pin the constants
      that depend on datacenter hardware we cannot measure here.

The simulator charges these costs to *protocol event timelines* generated
by the same Algorithm-1/2 implementation the runtime uses; the figures
emerge from the protocol, not from hard-coded curves.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ClusterCosts:
    # --- control plane
    msg_latency_s: float = 2.0e-4       # one control hop (TCP, measured)
    sigchld_detect_s: float = 1.0e-3    # daemon notices a dead child
    channel_detect_s: float = 5.0e-3    # root notices a broken channel
    signal_s: float = 1.0e-4            # SIGREINIT delivery

    # --- process management (calibrated: Reinit++ ≈0.5 s process /
    # ≈1.5 s node, CR ≈3 s — the paper's §5.3/§5.4 absolute numbers)
    spawn_proc_s: float = 0.45          # fork+exec+MPI-init of one rank
    spawn_parallelism: int = 8          # concurrent spawns per daemon
    node_rehost_s: float = 0.5          # node failure: wire-up on new host
    scheduler_redeploy_s: float = 1.5   # CR: allocator + relaunch
    teardown_s: float = 0.6             # CR: kill + drain the old job

    # --- legacy serialized recovery engine (pre-pipelining): the old
    # runtime polled instead of waiting on events, and ran respawn,
    # drain and restore strictly one after another. Charged only to the
    # non-overlapped e2e path (measured: the removed sleeps were a 0.3 s
    # respawn/drain poll in the daemon and a 0.5 s drain in the root).
    poll_respawn_s: float = 0.3         # poll period: expected wait /2
    poll_drain_s: float = 0.5           # fixed teardown drain sleep

    # --- ULFM collectives [Bosilca et al.]: revoke is a flood; shrink and
    # agree are tree/allreduce-style with a per-rank linear component the
    # prototype exhibits at scale (paper Fig. 6: on par with Reinit++ up to
    # 64 ranks, ≈3× at 1024)
    ulfm_round_alpha_s: float = 2.0e-3      # per round, log2(n) factor
    ulfm_round_beta_s: float = 2.2e-4       # per round, linear-in-n factor
    ulfm_rounds: int = 4                    # revoke, shrink, agree, merge
    heartbeat_detect_s: float = 0.05        # observation period / 2

    # --- replica failover: promotion swaps a warm shadow in for the
    # failed rank — a PROMOTE broadcast, the shadow composing its
    # already-streamed frames from local memory, and the rejoin barrier.
    # No spawn, no file read, no recomputed steps.
    promote_compose_s: float = 0.02     # shadow composes warm delta frames
    standby_sync_s: float = 0.01        # standby root: final table catch-up
    rehome_s: float = 2.0e-3            # one daemon reconnects to standby

    # --- elastic shrinking recovery: no respawn anywhere — a SHRINK
    # broadcast, SIGREINIT to survivors, then the batch re-balance
    # (re-partitioning the step's work over the contracted data axis:
    # a metadata exchange plus per-survivor reassignment, not bulk state
    # movement — survivors restore from their own local copies)
    shrink_rebalance_s: float = 0.05

    # --- storage
    lustre_agg_bw_MBps: float = 50_000.0    # shared parallel-FS aggregate
    lustre_latency_s: float = 0.02
    mem_copy_bw_MBps: float = 8_000.0       # local DRAM/HBM snapshot
    nic_bw_MBps: float = 1_200.0            # buddy copy, per rank pair

    # --- barrier (ORTE tree over root<->daemon<->rank)
    def tree_barrier_s(self, n_ranks: int, ranks_per_node: int) -> float:
        n_nodes = max(1, n_ranks // ranks_per_node)
        depth = 2 + math.ceil(math.log2(max(n_nodes, 2)))
        return depth * self.msg_latency_s

    def file_write_s(self, n_ranks: int, mb_per_rank: float) -> float:
        """All ranks write simultaneously to the shared filesystem: the
        aggregate bandwidth is the bottleneck → linear in world size."""
        return self.lustre_latency_s + \
            (n_ranks * mb_per_rank) / self.lustre_agg_bw_MBps

    def file_read_s(self, n_ranks: int, mb_per_rank: float,
                    readers: int | None = None) -> float:
        """Reads after recovery: only `readers` ranks hit the FS at once
        (CR: all; Reinit node: the re-spawned node's ranks)."""
        r = n_ranks if readers is None else readers
        return self.lustre_latency_s + \
            (r * mb_per_rank) / self.lustre_agg_bw_MBps

    def mem_ckpt_s(self, mb_per_rank: float) -> float:
        """Local snapshot + buddy push overlap; pairs are parallel."""
        return mb_per_rank / self.mem_copy_bw_MBps + \
            mb_per_rank / self.nic_bw_MBps

    def shrink_recovery_s(self, n_ranks: int, ranks_per_node: int) -> float:
        """SHRINK broadcast over the root->daemon tree + survivor signals
        + batch re-balance + the rejoin barrier. No spawn term at all —
        that absence is the mechanism's whole advantage."""
        n_nodes = max(1, n_ranks // max(ranks_per_node, 1))
        bcast = self.msg_latency_s * (1 + math.ceil(
            math.log2(max(n_nodes, 2))))
        return bcast + self.signal_s * ranks_per_node \
            + self.shrink_rebalance_s \
            + self.tree_barrier_s(n_ranks, ranks_per_node)

    def grow_recovery_s(self, n_ranks: int, ranks_per_node: int,
                        n_added: int) -> float:
        """Grow-back at a checkpoint boundary: the GROW broadcast over the
        root->daemon tree, SIGREINIT to survivors, the rejoined daemon's
        parallel spawn of the re-admitted ranks (wired up on the repaired
        host), and the rejoin barrier over the re-expanded world. The
        restore term (re-admitted ranks re-reading their pinned files) is
        charged separately, like every other recovery's read."""
        n_nodes = max(1, n_ranks // max(ranks_per_node, 1))
        bcast = self.msg_latency_s * (1 + math.ceil(
            math.log2(max(n_nodes, 2))))
        waves = math.ceil(n_added / max(self.spawn_parallelism, 1))
        return bcast + self.signal_s * max(n_ranks - n_added, 0) \
            + waves * self.spawn_proc_s + self.node_rehost_s \
            + self.tree_barrier_s(n_ranks, ranks_per_node)

    def promote_s(self, n_ranks: int, ranks_per_node: int,
                  n_promoted: int = 1) -> float:
        """Zero-rollback failover: PROMOTE broadcast over the root->daemon
        tree, the promoted shadows composing their streamed frames from
        local memory (parallel across shadows), and the rejoin barrier
        that re-forms the ring. Every other recovery's dominant terms —
        spawn, file read, rolled-back recompute — are absent, which is
        the strategy's entire point."""
        n_nodes = max(1, n_ranks // max(ranks_per_node, 1))
        bcast = self.msg_latency_s * (1 + math.ceil(
            math.log2(max(n_nodes, 2))))
        return bcast + self.promote_compose_s \
            + self.tree_barrier_s(n_ranks, ranks_per_node)

    def standby_takeover_s(self, n_ranks: int, ranks_per_node: int) -> float:
        """Root loss under replica: daemons notice the dead channel,
        re-home to the warm standby (parallel reconnects, charged once),
        the standby reconciles its mirrored tables, and the cluster
        resumes — no external relaunch, no worker ever restarts."""
        return self.channel_detect_s + self.rehome_s \
            + self.standby_sync_s \
            + self.tree_barrier_s(n_ranks, ranks_per_node)

    def degraded_step_s(self, step_time_s: float,
                        slow_factor: float) -> float:
        """Whole-job step time with one gray (degraded) member: the BSP
        barrier couples the world to its slowest rank, so a single node
        running at 1/slow_factor throughput slows *every* step to the
        victim's pace. This is what makes tolerating a gray failure a
        per-step tax on the whole job rather than a local problem."""
        return step_time_s * max(slow_factor, 1.0)

    def ulfm_recovery_collectives_s(self, n_ranks: int) -> float:
        per_round = self.ulfm_round_alpha_s * math.log2(max(n_ranks, 2)) \
            + self.ulfm_round_beta_s * n_ranks
        return self.ulfm_rounds * per_round


@dataclasses.dataclass(frozen=True)
class AppProfile:
    """Proxy-app stand-ins (weak scaling: per-rank work constant).

    step_time_s / ckpt_mb_per_rank are synthetic but sized like the paper's
    proxies (CoMD molecular dynamics, HPCCG CG solver, LULESH hydro)."""
    name: str
    step_time_s: float
    ckpt_mb_per_rank: float
    n_steps: int


APPS = {
    "comd": AppProfile("CoMD", step_time_s=1.10, ckpt_mb_per_rank=60.0,
                       n_steps=20),
    "hpccg": AppProfile("HPCCG", step_time_s=0.45, ckpt_mb_per_rank=30.0,
                        n_steps=25),
    "lulesh": AppProfile("LULESH", step_time_s=0.70, ckpt_mb_per_rank=45.0,
                         n_steps=20),
}
