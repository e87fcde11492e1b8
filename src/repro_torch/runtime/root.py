"""Root (HNP): deployment, liveness, Algorithm 1, recovery orchestration.

Four recovery modes — the paper's two measured approaches plus the
elastic extension it defers as future work and the zero-rollback
replica extension:

  reinit  Algorithm 1 + REINIT broadcast: survivors roll back in place,
          only failed ranks are re-spawned (on the least-loaded node for
          node failures). Recovery cost is confined to the root↔daemon
          tree.
  cr      Checkpoint-Restart: tear the whole job down (SIGKILL every
          daemon) and re-deploy it from scratch; every rank restarts from
          the file checkpoint.
  shrink  Elastic: failures consult the spare pool (Algorithm 1's
          least-loaded choice re-hosts onto a spare while one exists);
          once the pool is exhausted, a SHRINK broadcast drops the lost
          ranks (a node's whole group, or a single rank — leaving uneven
          groups) down to the --min-data-parallel world floor — survivors
          re-balance over the contracted world and resume from the
          consistent cut instead of aborting. The membership machine
          (repro_torch.core.membership) makes every decision and bumps the mesh
          epoch. Bidirectional: a repaired node's daemon re-registers
          (REJOIN) and the admission policy either re-admits the dropped
          ranks at the next checkpoint boundary (GROW broadcast: expanded
          world, bumped mesh epoch, re-admitted ranks restore from the
          pinned pre-shrink cut) or adds the node to the spare pool.
  replica Zero-rollback failover: every rank gets a warm shadow on
          another node (spare nodes first) that applies the primary's
          per-step checkpoint stream. A fenced failure is recovered by
          PROMOTE — the shadow composes its newest warm frame and joins
          the stalled barrier in the victim's place. No SIGREINIT, no
          epoch bump, no respawn: survivors never leave their barrier
          wait, so recovery is promote-and-reform and the resume step IS
          the failure step. Faults the stream cannot cover (mid-write
          kills, a cold or dead shadow, a NACKing shadow) fall back to
          the reinit path. A warm-standby root mirrors the rank/daemon
          tables over a replication channel and takes over on HNP loss
          (daemons re-home to it) — root failure no longer needs an
          external job restart.

The root measures, with wall clocks, the same phases the paper reports:
detection→REINIT-broadcast, re-registration (MPI recovery), and the first
post-recovery barrier (rejoin). Results land in a JSON report consumed by
benchmarks/runtime_bench.py.

The port's copy: it spawns the port's daemons (`repro_torch.runtime.daemon`)
and standby root, and passes `--device` (default `cuda`) down to every
worker, whose state then lives on that device. The report adds, per rank,
the finishing incarnation's kernel launch counts and start-up times
(`workers`). The root imports no torch.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

from repro_torch.core.elastic import ElasticManager, MeshEpoch
from repro_torch.core.events import FailureEvent, FailureType
from repro_torch.core.protocol import ClusterView, root_handle_failure, \
    root_handle_failure_promote
from repro_torch.core.recovery import STRATEGIES
from repro_torch.scenarios.schema import GRAY_DRAIN_PERSIST, GRAY_HOWS, \
    ROOT_INJECTED_EXIT, Scenario, gray_delay_s

from .transport import connect, listener, recv_msg, send_msg

# every registered strategy the live process tree can execute; ulfm is
# sim-only by design (its revoke/shrink/agree collectives are modeled,
# not implemented). Derived from the strategy registry so the CLI can
# never drift from it.
MODES = tuple(k for k in STRATEGIES if k != "ulfm")


class Root:
    def __init__(self, args):
        self.args = args
        self.world = args.nodes * args.ranks_per_node
        self.view = ClusterView.build(args.nodes, args.ranks_per_node,
                                      args.spares)
        # live membership — a set, not a count: a shrinking recovery
        # leaves non-contiguous rank ids behind
        self.world_ranks: set[int] = set(self.view.ranks())
        # elastic mode: one node = one data-parallel group; the
        # membership machine owns the spare pool, the shrink/grow
        # decisions, the dropped-rank ledger and the mesh epochs that
        # key the survivors' compiled-step caches
        self.elastic = ElasticManager(
            self.view, MeshEpoch(epoch=0, data_parallel=args.nodes,
                                 model_parallel=args.ranks_per_node),
            min_data_parallel=getattr(args, "min_data_parallel", 1)) \
            if args.mode == "shrink" else None
        self.sock = listener()
        self.port = self.sock.getsockname()[1]
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self.daemon_socks: dict[str, object] = {}
        self.daemon_pids: dict[str, int] = {}
        self.daemon_procs: dict[str, subprocess.Popen] = {}
        self.rank_table: dict[int, tuple[str, int]] = {}
        self._rank_pids: dict[int, int] = {}   # rank -> live incarnation
        self.barrier: dict[tuple[int, int], dict[int, float]] = {}
        self.fences: dict[tuple[int, int], int] = {}  # kill-barrier victims
        self.joins: dict[int, dict[int, int]] = {}   # epoch -> rank -> avail
        # True while the current epoch's rejoin consensus has not yet
        # released: a rank dying inside this window is a cascade of the
        # recovery in flight (it must merge — survivors are still blocked
        # on its vote), never a fresh failure, even when the rank table
        # already rebroadcast (recovering == False)
        self._join_open = True              # initial deploy consensus
        self.epoch = 0
        self.done: set[int] = set()
        self.recovering = False
        self.shutting_down = False
        self.timeline: list[dict] = []
        self.report: dict = {"mode": args.mode, "world": self.world,
                             "events": []}
        # stall watchdog (armed by --stall-timeout > 0): first-arrival
        # clocks per open barrier, and the set of ranks already ordered
        # killed so a slow SIGCHLD doesn't double-fire
        self.stall_timeout = getattr(args, "stall_timeout", 0.0)
        self._barrier_seen: dict[tuple, float] = {}
        self._stall_killed: set[int] = set()
        self._detect_mark: tuple | None = None  # (detector, latency, rank)
        self._detect_mark_node: tuple | None = None  # (by, latency, node)
        # daemon-level heartbeat ring: wport of each live daemon's
        # listener, broadcast as DAEMON_TABLE so daemons observe their
        # ring successor (hung-*daemon* detection)
        self.daemon_ports: dict[str, int] = {}
        # grow-back: initial rank->node map (repairs name the node that
        # originally hosted a rank), repairs due per step, nodes whose
        # next REGISTER_DAEMON is a REJOIN, and admitted nodes queued for
        # the GROW at the next checkpoint boundary
        self._initial_parent = {r: self.view.parent(r)
                                for r in range(self.world)}
        self._repairs: dict[int, list[str]] = {}
        self._rejoining: set[str] = set()
        self._pending_grow: list[str] = []
        self._held_release: tuple | None = None   # barrier paused for a
                                                  # rejoin in flight
        # replica mode: warm shadows (rank -> peer addr / hosting daemon /
        # pid) and the in-flight promote ledger (rank -> hosting daemon,
        # consulted when a PROMOTE_NACK or a mid-promote death arrives)
        self.shadow_table: dict[int, tuple[str, int]] = {}
        self._shadow_parent: dict[int, str] = {}
        self._shadow_pids: dict[int, int] = {}
        self._promote_inflight: dict[int, str] = {}
        self._await_shadows: set[int] = set()   # gate the initial table
                                                # broadcast on warm cover
        # warm-standby root: spawned before deploy in replica mode; the
        # registration carries the standby's listener port, which daemons
        # get on their spawn command line so they can re-home on HNP loss
        self.standby_proc: subprocess.Popen | None = None
        # the replication channel is installed by the accept thread
        # (STANDBY_REGISTER) while the serve loop reads it per event
        self._standby_lock = threading.Lock()
        self.standby_sock = None        # guarded-by: _standby_lock
        self._standby_port = 0
        self._standby_ready = threading.Event()
        self._standby_active = False
        # root-target scenario faults: {step: fault_index}
        self._root_faults: dict[int, int] = {}
        # gray-failure mitigation, armed by the scenario's mitigate knob:
        # a per-rank tracker over barrier lateness (arrival minus the
        # step's first arrival). A rank on a GRAY_DRAIN_PERSIST flag
        # streak is drained at the next completed barrier — see
        # _maybe_drain_stragglers. min_flag_s at half the smallest
        # injected delay keeps scheduler jitter below the trigger.
        self._straggler = None
        if getattr(args, "scenario", ""):
            sc = Scenario.load(args.scenario)
            self._root_faults = {f.step: i for i, f in sc.root_faults()}
            for r in sc.repairs:
                node = self._initial_parent[r.rank]
                self._repairs.setdefault(r.step, []).append(node)
            gray = [f for f in sc.faults if f.how in GRAY_HOWS]
            if sc.mitigate and gray:
                from repro_torch.train.straggler import StragglerTracker
                self._straggler = StragglerTracker(
                    window=32, threshold_mads=4.0, min_samples=2,
                    min_flag_s=0.5 * min(gray_delay_s(f) for f in gray))
        threading.Thread(target=self._accept_loop, daemon=True).start()

    # ------------------------------------------------------------ fabric

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._daemon_conn, args=(conn,),
                             daemon=True).start()

    def _daemon_conn(self, conn):
        node = None
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    break
                if msg["type"] == "STANDBY_REGISTER":
                    # the warm standby announcing itself: keep the channel
                    # as the replication stream, never queue it as a
                    # cluster event
                    self._standby_port = msg["port"]
                    with self._standby_lock:
                        self.standby_sock = conn
                    self._standby_ready.set()
                    continue
                if msg["type"] == "REGISTER_DAEMON":
                    node = msg["node"]
                    self.daemon_socks[node] = conn
                    self.daemon_pids[node] = msg["pid"]
                    self.daemon_ports[node] = msg.get("port", 0)
                self.events.put(("msg", msg))
        except OSError:
            pass
        if node is not None:
            # carry the socket identity: a channel that was already
            # replaced (CR teardown + re-deploy) must not be mistaken
            # for a failure of the *new* daemon on the same node
            self.events.put(("channel_broken", (node, conn)))

    def _broadcast(self, msg: dict, nodes=None):
        for node, s in list(self.daemon_socks.items()):
            if nodes is not None and node not in nodes:
                continue
            try:
                send_msg(s, msg)
            except OSError:
                pass

    # -------------------------------------------------------- deployment

    def _spawn_daemon(self, node: str):
        a = self.args
        cmd = [sys.executable, "-m", "repro_torch.runtime.daemon",
               "--node", node, "--root-port", str(self.port),
               "--world", str(self.world), "--steps", str(a.steps),
               "--dim", str(a.dim), "--fail-step", str(a.fail_step),
               "--fail-rank", str(a.fail_rank), "--fail-kind", a.fail_kind,
               "--scenario", getattr(a, "scenario", ""),
               "--hb-period", str(getattr(a, "hb_period", 0.0)),
               "--hb-timeout", str(getattr(a, "hb_timeout", 0.0)),
               "--standby-port", str(self._standby_port),
               "--ckpt-dir", a.ckpt_dir, "--pythonpath", a.pythonpath,
               "--device", a.device]
        env = dict(os.environ, PYTHONPATH=a.pythonpath)
        self.daemon_procs[node] = subprocess.Popen(cmd, env=env)

    def deploy(self):
        t0 = time.monotonic()
        for node in self.view.daemons():
            self._spawn_daemon(node)
        # wait for all daemons to register, then hand them their ranks
        need = set(self.view.daemons())
        while need:
            kind, msg = self.events.get(timeout=30)
            if kind == "msg" and msg["type"] == "REGISTER_DAEMON":
                need.discard(msg["node"])
        for node in self.view.daemons():
            ranks = sorted(self.view.children[node])
            if ranks:
                send_msg(self.daemon_socks[node],
                         {"type": "SPAWN", "ranks": ranks,
                          "restarted": False, "epoch": self.epoch})
        self.report["deploy_start_s"] = t0

    # ---------------------------------------------------- replica fabric

    def _spawn_standby(self):
        """Spawn the warm-standby root and wait for it to register: its
        listener port goes on every daemon's command line (the re-home
        target), so it must exist before the first daemon spawns."""
        a = self.args
        cmd = [sys.executable, "-m", "repro_torch.runtime.root",
               "--nodes", str(a.nodes),
               "--ranks-per-node", str(a.ranks_per_node),
               "--spares", str(a.spares), "--steps", str(a.steps),
               "--dim", str(a.dim), "--mode", a.mode,
               "--min-data-parallel", str(getattr(a, "min_data_parallel", 1)),
               "--scenario", getattr(a, "scenario", ""),
               "--ckpt-dir", a.ckpt_dir, "--report", a.report,
               "--pythonpath", a.pythonpath, "--device", a.device,
               "--as-standby", "--primary-port", str(self.port)]
        env = dict(os.environ, PYTHONPATH=a.pythonpath)
        self.standby_proc = subprocess.Popen(cmd, env=env)
        if not self._standby_ready.wait(timeout=30):
            raise TimeoutError("standby root never registered")

    def _deploy_shadows(self):
        """One warm shadow per rank, hosted off the rank's own node —
        spare nodes first (the paper's over-provisioning absorbs the
        shadow load), other compute nodes otherwise. Shadows are
        pre-admitted members with warm state: they apply the primary's
        per-step checkpoint stream and only enter the BSP loop on
        PROMOTE."""
        spares = self.view.spares()
        computes = [d for d in self.view.daemons()
                    if self.view.children.get(d)]
        pool = spares or computes
        by_daemon: dict[str, list[int]] = {}
        i = 0
        for r in sorted(self.view.ranks()):
            home = self.view.parent(r)
            cands = [d for d in pool if d != home] \
                or [d for d in computes if d != home]
            if not cands:
                continue            # single-node world: nowhere to shadow
            host = cands[i % len(cands)]
            i += 1
            self._shadow_parent[r] = host
            by_daemon.setdefault(host, []).append(r)
        # hold the initial table broadcast until every shadow registered:
        # the zero-rollback guarantee needs the stream warm from step 1 —
        # otherwise a slow-deploying shadow joins mid-chain and the first
        # failure races its warm-up
        self._await_shadows = {r for rs in by_daemon.values() for r in rs}
        for host, ranks in by_daemon.items():
            send_msg(self.daemon_socks[host],
                     {"type": "SPAWN", "ranks": sorted(ranks),
                      "restarted": False, "epoch": self.epoch,
                      "shadow": True})

    def _table_msg(self, partial: bool = False) -> dict:
        msg = {"type": "RANK_TABLE", "epoch": self.epoch,
               "world": sorted(self.world_ranks),
               "table": {str(k): list(v) for k, v in
                         self.rank_table.items()}}
        if partial:
            msg["partial"] = True
        if self.shadow_table:
            # primaries stream their per-step frames to their own shadow
            msg["shadows"] = {str(k): list(v) for k, v in
                              self.shadow_table.items()}
        return msg

    def _sync_standby(self):
        """Replicate the root's authoritative tables to the warm standby.
        Called once per processed event — the stream is tiny (rank/daemon
        tables + report), and a takeover needs nothing newer than the
        last completed event."""
        with self._standby_lock:
            standby = self.standby_sock
        if standby is None:
            return
        try:
            send_msg(standby, {
                "type": "SYNC", "epoch": self.epoch,
                "world": sorted(self.world_ranks),
                "table": {str(k): list(v) for k, v in
                          self.rank_table.items()},
                "pids": {str(k): v for k, v in self._rank_pids.items()},
                "shadows": {str(k): list(v) for k, v in
                            self.shadow_table.items()},
                "shadow_parent": {str(k): v for k, v in
                                  self._shadow_parent.items()},
                "shadow_pids": {str(k): v for k, v in
                                self._shadow_pids.items()},
                "children": {d: sorted(rs) for d, rs in
                             self.view.children.items()},
                "view_epoch": self.view.epoch,
                "done": sorted(self.done),
                "report": self.report})
        except OSError:
            with self._standby_lock:      # standby died: run uncovered
                self.standby_sock = None

    # ----------------------------------------------------------- barrier

    def _barrier_arrive(self, msg):
        key = (msg["epoch"], msg["step"])
        if msg["epoch"] != self.epoch:
            return                          # stale pre-recovery arrival
        d = self.barrier.setdefault(key, {})
        t_first = self._barrier_seen.setdefault(key, time.monotonic())
        if self._straggler is not None and msg["rank"] not in d:
            # per-rank lateness relative to the step's first arrival:
            # the signal a slow or lossy rank cannot hide — it does all
            # the work, just late, and every other rank is already here
            self._straggler.observe(key[1], time.monotonic() - t_first,
                                    rank=msg["rank"])
        d[msg["rank"]] = msg["value"]
        if len(d) == len(self.world_ranks):
            # a completed barrier is a checkpoint boundary: every rank
            # has committed this step's checkpoint, which makes it the
            # one safe place to drain a persistent straggler — the
            # consistent cut is exactly this step
            if self._maybe_drain_stragglers(key):
                return
            # A due node repair restarts the repaired node's daemon here
            # and HOLDS this release until its REJOIN is admitted: the
            # world is paused at the boundary, so the grow (or spare
            # grant) lands deterministically between steps, never racing
            # the run to completion
            if self._check_repairs(key[1]):
                self._held_release = (key, d)
                del self.barrier[key]
                self._barrier_seen.pop(key, None)
                return
            # reduce in rank order: float addition is order-sensitive, and
            # a deterministic reduction is what makes a recovered run
            # land on the bit-identical state of the fault-free run
            total = sum(d[r] for r in sorted(d))
            self._broadcast({"type": "BARRIER_RELEASE",
                             "epoch": key[0], "step": key[1],
                             "value": total})
            del self.barrier[key]
            self._barrier_seen.pop(key, None)
            if self.report["events"]:
                ev = self.report["events"][-1]
                if ev.get("promote") and "promote_complete_s" not in ev \
                        and ev.get("t_recover_start"):
                    # the promoted shadow's arrival completed the stalled
                    # barrier: the whole world is computing again — the
                    # replica failover's true end-to-end recovery time.
                    # The promotion window is over: later deaths of these
                    # ranks are ordinary new failures, not window deaths.
                    ev["promote_complete_s"] = \
                        time.monotonic() - ev["t_recover_start"]
                    self._promote_inflight.clear()
            self._maybe_die_as_root(key[1])
            if getattr(self, "_first_barrier_after_recovery", None) is not None:
                t0 = self._first_barrier_after_recovery
                self.report["events"][-1]["rejoin_barrier_s"] = \
                    time.monotonic() - t0
                self._first_barrier_after_recovery = None
        else:
            self._maybe_release_fence(key)

    def _fence_arrive(self, msg):
        """Deterministic kill barrier: a fault-injecting victim FENCEs at
        its kill step instead of dying immediately. The fence releases —
        and only then does the victim die — once every *other* rank has
        arrived at that step's barrier, i.e. has completed the previous
        iteration and committed its checkpoint for this step. The
        consistent cut after recovery is then always exactly the fence
        step, killing the timing dependence SIGKILL injection used to
        have."""
        key = (msg["epoch"], msg["step"])
        if msg["epoch"] != self.epoch:
            return
        self.fences[key] = msg["rank"]
        self._maybe_release_fence(key)

    def _maybe_release_fence(self, key):
        victim = self.fences.get(key)
        if victim is None:
            return
        arrived = self.barrier.get(key, {})
        if len(arrived) >= len(self.world_ranks) - 1:
            self._broadcast({"type": "FENCE_RELEASE",
                             "epoch": key[0], "step": key[1]})
            del self.fences[key]

    def _join_arrive(self, msg):
        """ORTE-style rejoin barrier + consistent-rollback consensus: the
        resume step is the minimum checkpoint available across all ranks
        (ranks can be one step apart when a failure lands mid-save)."""
        if msg["epoch"] != self.epoch:
            return
        d = self.joins.setdefault(msg["epoch"], {})
        d[msg["rank"]] = msg["avail"]
        if len(d) == len(self.world_ranks):
            resume = min(d.values())
            self._broadcast({"type": "JOIN_RELEASE", "epoch": msg["epoch"],
                             "resume": resume})
            del self.joins[msg["epoch"]]
            self._join_open = False
            if self.report["events"]:
                ev = self.report["events"][-1]
                if "resume_step" not in ev and ev.get("t_recover_start"):
                    ev["resume_step"] = resume
                    ev["join_release_s"] = \
                        time.monotonic() - ev["t_recover_start"]

    def _maybe_drain_stragglers(self, key) -> bool:
        """Gray-failure mitigation: called with a COMPLETED barrier,
        before its release. A rank on a GRAY_DRAIN_PERSIST consecutive
        flag streak is persistently degraded — withhold the release and
        order it killed (its whole node, when the flagged set covers the
        node's live ranks). Every rank committed step `key[1]`'s
        checkpoint before arriving, so the ensuing SIGCHLD/EOF-driven
        shrink resumes from exactly this boundary; the drained rank's
        eventual grow-back incarnation spawns healthy (--restarted
        drops the gray plan) and is re-admitted on merit. Returns True
        when a drain was ordered (the caller then skips the release)."""
        if (self._straggler is None or self.recovering
                or self.shutting_down):
            return False
        flagged = self._straggler.stragglers(
            persist=GRAY_DRAIN_PERSIST) & self.world_ranks
        if not flagged:
            return False
        now = time.monotonic()
        t0 = self._barrier_seen.get(key)
        lat = None if t0 is None else now - t0
        # node drain when a whole node's live ranks are on a streak —
        # the degradation is the node's, not any one process's
        for node in sorted(self.view.children):
            live = set(self.view.children[node]) & self.world_ranks
            if not live or not live <= flagged:
                continue
            sock = self.daemon_socks.get(node)
            if sock is None:
                continue
            try:
                send_msg(sock, {"type": "KILL_NODE"})
            except OSError:
                continue
            self._detect_mark_node = ("straggler", lat, node)
            del self.barrier[key]
            self._barrier_seen.pop(key, None)
            return True
        rank = min(flagged)
        try:
            daemon = self.view.parent(rank)
        except KeyError:
            return False
        sock = self.daemon_socks.get(daemon)
        if sock is None:
            return False
        try:
            send_msg(sock, {"type": "KILL_RANK", "rank": rank})
        except OSError:
            return False
        self._stall_killed.add(rank)
        self._detect_mark = ("straggler", lat, rank)
        del self.barrier[key]
        self._barrier_seen.pop(key, None)
        return True

    # ------------------------------------------------- injection/watchdog

    def _maybe_die_as_root(self, step: int):
        """Root-target fault: die right after releasing this step's
        barrier. The HNP is Reinit++'s single point of failure — only an
        external job restart (the engine relaunching this command, the
        sentinel stopping a re-fire) recovers from it."""
        idx = self._root_faults.get(step)
        if idx is None:
            return
        sentinel = os.path.join(self.args.ckpt_dir, f"INJECTED_root_f{idx}")
        try:
            fd = os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return
        os.write(fd, f"root step={step}".encode())
        os.close(fd)
        os._exit(ROOT_INJECTED_EXIT)

    def _order_kill(self, rank: int, by: str):
        """Order a silent rank's daemon to SIGKILL it (stall watchdog or a
        neighbour-heartbeat SUSPECT); the resulting SIGCHLD drives the
        ordinary failure path. Records which detector fired and how long
        after the stuck barrier's first arrival — the measured detection
        latency the benchmark compares across detectors."""
        if rank in self._stall_killed:
            return
        self._stall_killed.add(rank)
        try:
            daemon = self.view.parent(rank)
        except KeyError:
            return
        sock = self.daemon_socks.get(daemon)
        if sock is None:
            return
        now = time.monotonic()
        t0 = min((t for k, t in self._barrier_seen.items()
                  if k[0] == self.epoch), default=None)
        try:
            send_msg(sock, {"type": "KILL_RANK", "rank": rank})
        except OSError:
            return      # kill never delivered: claim no detection credit
        self._detect_mark = (by, None if t0 is None else now - t0, rank)

    def _check_stalls(self):
        """Stall watchdog: a barrier stuck past --stall-timeout with a
        subset of the world arrived means the missing ranks are silent
        (hung or partitioned but undead) — order their daemons to SIGKILL
        them."""
        if (self.stall_timeout <= 0 or self.recovering
                or self.shutting_down):
            return
        now = time.monotonic()
        for key, t0 in list(self._barrier_seen.items()):
            if key[0] != self.epoch or now - t0 < self.stall_timeout:
                continue
            arrived = set(self.barrier.get(key, {}))
            missing = self.world_ranks - arrived - self.done
            for rank in sorted(missing - self._stall_killed):
                self._order_kill(rank, "watchdog")

    def _handle_suspect(self, msg):
        """A worker's heartbeat observer timed out on its ring successor
        and reported SUSPECT: kill the silent rank so SIGCHLD recovery
        runs — detection without any watchdog timeout on the path."""
        rank = msg["rank"]
        if (self.recovering or self.shutting_down
                or rank not in self.world_ranks or rank in self.done
                or msg.get("epoch", self.epoch) != self.epoch):
            return
        self._order_kill(rank, "heartbeat")

    def _handle_suspect_node(self, msg):
        """A daemon's ring observer timed out on its successor *daemon*:
        the whole node is silent (a hung daemon relays nothing — its
        children's barrier traffic, CHILD_DEADs and heartbeat ACKs all
        stop). SIGKILL the hung daemon: the channel EOF then drives the
        ordinary node-failure path, credited to the heartbeat ring."""
        node = msg["node"]
        if (self.recovering or self.shutting_down
                or node not in self.view.children):
            return
        pid = self.daemon_pids.get(node)
        if pid is None:
            return
        now = time.monotonic()
        t0 = min((t for k, t in self._barrier_seen.items()
                  if k[0] == self.epoch), default=None)
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            return
        self._detect_mark_node = \
            ("heartbeat", None if t0 is None else now - t0, node)

    # --------------------------------------------------------- grow-back

    def _check_repairs(self, step: int) -> bool:
        """Scenario-driven node repair: at the step's checkpoint boundary
        the repaired node's daemon restarts and re-registers. Returns
        True when a daemon was (re)started — the caller then holds the
        boundary's barrier release until the REJOIN is admitted. Only the
        elastic mode acts on repairs; the other modes never shrank, so a
        repair is meaningless there (and CR resurrects dead nodes
        wholesale on its own)."""
        if self.elastic is None or self.shutting_down:
            self._repairs.pop(step, None)
            return False
        started = False
        for node in self._repairs.pop(step, []):
            if node in self.daemon_socks or node in self.view.children:
                continue            # never left / already back
            self._rejoining.add(node)
            self._spawn_daemon(node)
            started = True
        return started

    def _release_held(self):
        """Release the barrier held for a rejoin that did not re-shape
        the world (spare admission): the paused boundary resumes exactly
        where it stopped. A grow never gets here — its epoch bump voids
        the held barrier and the rollback consensus takes over."""
        held, self._held_release = self._held_release, None
        if held is None:
            return
        key, d = held
        if key[0] != self.epoch:
            return
        total = sum(d[r] for r in sorted(d))
        self._broadcast({"type": "BARRIER_RELEASE", "epoch": key[0],
                         "step": key[1], "value": total})
        self._maybe_die_as_root(key[1])

    def _handle_rejoin(self, node: str):
        """REJOIN: a repaired node's daemon re-registered while the world
        is paused at the repair step's boundary. Root-side admission
        policy (the membership machine): re-admit the dropped ranks
        (GROW) when the world is shrunk, else grant the node into the
        spare pool and resume the paused boundary."""
        if self.elastic.admit(node) == "spare":
            self.elastic.grant_spare(node)
            self.report["events"].append(
                {"rejoin": node, "admitted": "spare",
                 "spares": self.elastic.spares()})
            self._release_held()
            return
        if self.recovering:
            self._pending_grow.append(node)    # folded in after recovery
            return
        self._execute_grow(node)

    def _execute_grow(self, node: str):
        """GROW broadcast at a checkpoint boundary: re-admit the most
        recently dropped rank group onto the rejoined node. Survivors get
        SIGREINIT + the expanded membership (bumped epoch and mesh
        epoch); the rejoined daemon spawns the re-admitted ranks, which
        restore from the durable checkpoints they committed before being
        dropped — the consensus therefore lands exactly on the pinned
        pre-shrink cut, and the re-expanded world replays from it."""
        if node not in self.daemon_socks:
            return                  # the repaired node died again already
        t0 = time.monotonic()
        cmd = self.elastic.grow(node)
        self.epoch = cmd.epoch
        self.recovering = True
        self._reset_sync_state()
        for r in cmd.added:
            self.rank_table.pop(r, None)
            self._rank_pids.pop(r, None)
        self.world_ranks = set(cmd.world)
        self._pending_respawn = set(cmd.added)
        ev = {"grow": True, "node": node, "added": sorted(cmd.added),
              "world_after": len(cmd.world),
              "mesh_epoch": cmd.mesh_epoch,
              "detect_at_s": t0, "detected_by": "rejoin"}
        self.report["events"].append(ev)
        self._broadcast({"type": "GROW", "epoch": self.epoch,
                         "world": sorted(cmd.world),
                         "mesh_epoch": cmd.mesh_epoch,
                         "respawns": [[node, r] for r in cmd.added]})
        # pipeline the restore with the spawn, like REINIT: survivors'
        # addresses go out immediately so the re-admitted ranks can try
        # buddy pulls while the rest of the world re-registers
        self._broadcast(self._table_msg(partial=True))
        ev["reinit_broadcast_s"] = time.monotonic() - t0
        ev["t_recover_start"] = t0

    # ---------------------------------------------------------- recovery

    def _respawn_during_recovery(self, rank: int):
        """Cascading failure: a rank died while a recovery is already in
        flight (a replacement dying mid-restore, a survivor dying right
        after rollback). Merge it into the current recovery — forget its
        address and any stale consensus vote, re-spawn it at its current
        daemon, and let it join the in-flight rejoin barrier."""
        self.rank_table.pop(rank, None)
        self.joins.get(self.epoch, {}).pop(rank, None)
        self._pending_respawn.add(rank)
        try:
            daemon = self.view.parent(rank)
        except KeyError:
            return
        sock = self.daemon_socks.get(daemon)
        if sock is None:
            return      # node recovery in flight; its respawn covers this
        if self.report["events"]:
            ev = self.report["events"][-1]
            ev["cascades"] = ev.get("cascades", 0) + 1
        try:
            send_msg(sock, {"type": "SPAWN", "ranks": [rank],
                            "restarted": True, "epoch": self.epoch})
        except OSError:
            pass

    def _handle_failure(self, failure: FailureEvent):
        if self.shutting_down:
            return
        if self.recovering:
            # A node failure can supersede an in-flight process recovery:
            # the dying daemon may have relayed its children's deaths just
            # before its channel broke. Process recovery targeting a dead
            # node would stall, so the node failure takes over; duplicate
            # process failures during recovery are stale and dropped.
            if failure.kind is not FailureType.NODE:
                return
        self.recovering = True
        t_detect = time.monotonic()
        ev = {"failure": str(failure), "kind": failure.kind.value,
              "detect_at_s": t_detect}
        mark, self._detect_mark = self._detect_mark, None
        nmark, self._detect_mark_node = self._detect_mark_node, None
        if mark is not None and failure.kind is FailureType.PROCESS \
                and failure.rank == mark[2]:
            # this failure is the SIGCHLD of the kill we ordered: credit
            # the detector that ordered it (watchdog vs heartbeat ring).
            # A mismatched failure (e.g. the whole node died under the
            # ordered kill) drops the mark — no misattributed credit.
            by, latency, _ = mark
            ev["detected_by"] = by
            if latency is not None:
                ev["detect_latency_s"] = latency
        elif nmark is not None and failure.kind is FailureType.NODE \
                and failure.node == nmark[2]:
            # the channel EOF of the daemon we SIGKILLed on the daemon
            # ring's SUSPECT_NODE: the heartbeat detected a hung *node*
            by, latency, _ = nmark
            ev["detected_by"] = by
            if latency is not None:
                ev["detect_latency_s"] = latency
        else:
            ev["detected_by"] = "channel" \
                if failure.kind is FailureType.NODE else "sigchld"
        # append before dispatch: recovery helpers (and the table
        # rebroadcast a shrink triggers synchronously) annotate
        # report["events"][-1]
        self.report["events"].append(ev)
        if self.args.mode == "cr":
            self._recover_cr(ev, failure)
        elif self.args.mode == "replica":
            self._recover_replica(ev, failure)
        elif self.elastic is not None \
                and self.elastic.decide(failure) == "shrink":
            self._recover_shrink(ev, failure)
        else:
            if self.elastic is not None:
                self.elastic.nonshrink_plan(failure)   # mesh bookkeeping
            self._recover_reinit(ev, failure)

    def _reset_sync_state(self):
        """Drop every pre-recovery synchronization artifact (open
        barriers, watchdog clocks, ordered kills, fences, consensus
        votes) — stale entries under a new epoch fire spurious
        releases/kills. Every recovery path starts with this."""
        self.barrier.clear()
        self._barrier_seen.clear()
        self._stall_killed.clear()
        self.fences.clear()
        self.joins.clear()
        self._held_release = None
        self._join_open = True     # every recovery re-runs the consensus
        if self._straggler is not None:
            # streaks describe pre-recovery incarnations; the drained
            # rank's healthy replacement starts with a clean slate
            self._straggler.reset_streaks()

    def _recover_reinit(self, ev, failure: FailureEvent):
        t0 = time.monotonic()
        cmd = root_handle_failure(self.view, failure)
        self.epoch = cmd.epoch
        self._reset_sync_state()
        # forget lost workers' addresses (and a lost node's daemon channel)
        if failure.kind is FailureType.NODE:
            lost = [r.rank for r in cmd.respawns]
            self.daemon_socks.pop(failure.node, None)
            self.daemon_pids.pop(failure.node, None)
            self.daemon_ports.pop(failure.node, None)
        else:
            lost = [failure.rank]
        for r in lost:
            self.rank_table.pop(r, None)
        self._pending_respawn = set(lost)
        self._broadcast({"type": "REINIT", "epoch": self.epoch,
                         "respawns": [[r.daemon, r.rank]
                                      for r in cmd.respawns]})
        # pipeline the restore with the respawn: push the survivors'
        # addresses (and the new epoch) out immediately so survivors roll
        # back and re-spawned ranks begin their buddy pulls while the
        # rest of the world is still re-registering — the full table
        # rebroadcast happens when all lost ranks are back
        self._broadcast(self._table_msg(partial=True))
        ev["reinit_broadcast_s"] = time.monotonic() - t0
        ev["t_recover_start"] = t0

    def _recover_shrink(self, ev, failure: FailureEvent):
        """Elastic shrinking recovery (spare pool exhausted): drop the
        lost ranks from the world instead of respawning — a whole node's
        group on a node loss, or a single rank on a process loss (the
        surviving groups then being uneven). Survivors get SIGREINIT +
        the SHRINK broadcast (shrunk rank membership, bumped epoch and
        mesh epoch), re-balance the batch over the contracted world, and
        resume from the consistent cut — which they keep pinned on disk
        as the grow-back anchor until a repaired node re-expands the
        world."""
        t0 = time.monotonic()
        cmd = self.elastic.shrink(failure)     # view+mesh+dropped ledger
        mesh_epoch = self.elastic.mesh.epoch
        self.epoch = cmd.epoch
        self._reset_sync_state()
        if failure.kind is FailureType.NODE:
            self.daemon_socks.pop(failure.node, None)
            self.daemon_pids.pop(failure.node, None)
            self.daemon_procs.pop(failure.node, None)
            self.daemon_ports.pop(failure.node, None)
        for r in cmd.dropped:
            self.rank_table.pop(r, None)
            self._rank_pids.pop(r, None)
            self.done.discard(r)
        self.world_ranks = set(cmd.world)
        self._pending_respawn = set()
        self._broadcast({"type": "SHRINK", "epoch": self.epoch,
                         "world": sorted(cmd.world),
                         "mesh_epoch": mesh_epoch})
        ev["shrink"] = True
        ev["dropped"] = sorted(cmd.dropped)
        ev["world_after"] = len(cmd.world)
        ev["mesh_epoch"] = mesh_epoch
        ev["reinit_broadcast_s"] = time.monotonic() - t0
        ev["t_recover_start"] = t0
        # no respawns: every survivor's address is already known, so the
        # full-table rebroadcast — and with it the recovery — completes
        # immediately; the remaining cost is the survivors' rollback
        self._maybe_broadcast_table()

    # ----------------------------------------------- replica (promote)

    def _drop_shadow(self, rank: int):
        self.shadow_table.pop(rank, None)
        self._shadow_parent.pop(rank, None)
        self._shadow_pids.pop(rank, None)

    def _handle_shadow_death(self, rank: int):
        """A warm shadow died (its own injected fault, or collateral).
        The rank's primary is untouched, so this is not a recovery — the
        rank just lost its zero-rollback cover and the next failure falls
        back to reinit."""
        self._drop_shadow(rank)
        if not self.shutting_down:
            self.report["events"].append({"shadow_lost": rank})

    def _can_promote(self, failure: FailureEvent):
        """Returns the zero-rollback resume step, or None when the
        failure is not promotable. Promotable means: every lost rank has
        a registered shadow hosted off the failed node, AND every
        survivor is already parked at one stalled barrier — the fenced
        consistent cut, which is exactly the step the warm frame holds.
        An unfenced failure (mid-write kill, hang) leaves survivors
        scattered and the stream behind the cut: fall back to reinit."""
        if failure.kind is FailureType.NODE:
            lost = sorted(self.view.children.get(failure.node, ()))
            if not lost:
                return None
        else:
            if failure.rank not in self.world_ranks:
                return None
            lost = [failure.rank]
        for r in lost:
            home = self._shadow_parent.get(r)
            if r not in self.shadow_table or home is None \
                    or home not in self.daemon_socks:
                return None
            if failure.kind is FailureType.NODE and home == failure.node:
                return None
        survivors = self.world_ranks - set(lost)
        for (ep, step), d in self.barrier.items():
            if ep == self.epoch and survivors <= set(d) \
                    and len(d) < len(self.world_ranks):
                return step
        return None

    def _recover_replica(self, ev, failure: FailureEvent):
        """Zero-rollback failover: promote the lost ranks' warm shadows
        in place, or fall back to Algorithm-1 reinit when the stream
        cannot cover this failure."""
        if failure.kind is FailureType.NODE:
            # the dead node takes the shadows it hosted with it
            doomed = sorted(r for r, h in self._shadow_parent.items()
                            if h == failure.node)
            for r in doomed:
                self._drop_shadow(r)
            if doomed:
                ev["shadows_lost"] = doomed
        resume = self._can_promote(failure)
        if resume is None:
            ev["promote"] = False
            self._recover_reinit(ev, failure)
            return
        self._recover_promote(ev, failure, resume)

    def _recover_promote(self, ev, failure: FailureEvent, resume: int):
        """PROMOTE: move each lost rank to its shadow's daemon, point the
        rank table at the shadow's peer listener, and tell the shadow to
        compose its warm frame and enter the BSP loop at `resume`.

        Deliberately NO epoch bump, NO SIGREINIT, NO _reset_sync_state():
        survivors stay parked at the stalled barrier — the promoted
        shadows' arrivals are what complete it. The rank-ordered
        reduction then sums the identical values a fault-free run would
        have, so the recovered run stays bit-identical."""
        t0 = time.monotonic()
        cmd = root_handle_failure_promote(self.view, failure,
                                          dict(self._shadow_parent))
        if failure.kind is FailureType.NODE:
            self.daemon_socks.pop(failure.node, None)
            self.daemon_pids.pop(failure.node, None)
            self.daemon_procs.pop(failure.node, None)
            self.daemon_ports.pop(failure.node, None)
        ev["promote"] = True
        ev["promoted"] = [p.rank for p in cmd.promotions]
        ev["resume_step"] = resume
        ev["t_recover_start"] = t0
        self._pending_respawn = set()
        for p in cmd.promotions:
            addr = self.shadow_table.pop(p.rank)
            home = self._shadow_parent.pop(p.rank)
            self._promote_inflight[p.rank] = home
            self.rank_table[p.rank] = addr
            self._rank_pids[p.rank] = self._shadow_pids.pop(p.rank, None)
            sock = self.daemon_socks.get(home)
            if sock is not None:
                try:
                    send_msg(sock, {"type": "PROMOTE", "rank": p.rank,
                                    "resume": resume,
                                    "epoch": self.epoch})
                except OSError:
                    pass
        ev["reinit_broadcast_s"] = time.monotonic() - t0
        self._maybe_broadcast_table()

    def _promote_window_death(self, rank: int):
        """A freshly-promoted shadow died inside the promotion window
        (after PROMOTE, before its barrier arrival completed the stalled
        cut). Merge into the recovery in flight: fall back to a reinit
        respawn annotated on the SAME consensus entry — never a second
        event, never a double promote, never a deadlocked barrier."""
        self._promote_inflight.pop(rank, None)
        ev = self.report["events"][-1]
        ev.setdefault("promote_window_death", []).append(rank)
        ev["promote"] = False
        self.recovering = True
        self._recover_reinit(ev, FailureEvent(kind=FailureType.PROCESS,
                                              rank=rank))

    def _promote_nack(self, msg):
        """The shadow cannot compose the agreed resume step (its stream
        lagged): kill it so the ordinary failure path re-runs — with the
        shadow gone, _recover_replica falls back to reinit."""
        r = msg["rank"]
        home = self._promote_inflight.pop(r, None)
        if home is None:
            return
        if self.report["events"]:
            ev = self.report["events"][-1]
            ev.setdefault("promote_nack", []).append(r)
        sock = self.daemon_socks.get(home)
        if sock is not None:
            try:
                send_msg(sock, {"type": "KILL_RANK", "rank": r})
            except OSError:
                pass

    def _recover_cr(self, ev, failure: FailureEvent):
        t0 = time.monotonic()
        # teardown: SIGKILL every daemon (daemons take children with them
        # on channel loss; be thorough and kill workers via daemons' procs)
        for node, pid in list(self.daemon_pids.items()):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in self.daemon_procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        self.daemon_socks.clear()
        self.daemon_pids.clear()
        self.daemon_procs.clear()
        self.daemon_ports.clear()
        self._rejoining.clear()
        self._pending_grow.clear()
        self.rank_table.clear()
        self._rank_pids.clear()     # every old incarnation died with the
                                    # teardown; their reports are stale
        self._reset_sync_state()
        self.done.clear()
        ev["teardown_s"] = time.monotonic() - t0
        # re-deploy the whole application
        self.epoch += 1
        self.view = ClusterView.build(self.args.nodes,
                                      self.args.ranks_per_node,
                                      self.args.spares)
        self.world_ranks = set(self.view.ranks())
        self._pending_respawn = set(range(self.world))
        self.deploy()
        ev["t_recover_start"] = t0

    # --------------------------------------------------------------- run

    def _maybe_broadcast_table(self):
        if self._await_shadows:
            return      # replica deploy: shadows still coming up
        if len(self.rank_table) == len(self.world_ranks):
            self._broadcast(self._table_msg())
            # daemon ring membership for hung-daemon observation: every
            # live daemon (spares included) observes its ring successor
            self._broadcast({"type": "DAEMON_TABLE", "epoch": self.epoch,
                             "table": {d: self.daemon_ports[d]
                                       for d in self.view.daemons()
                                       if d in self.daemon_ports}})
            if self.recovering:
                ev = self.report["events"][-1] if self.report["events"] \
                    else None
                t0 = self._last_recover_start()
                if ev is not None and t0 is not None:
                    ev["mpi_recovery_s"] = time.monotonic() - t0
                self.recovering = False
                self._first_barrier_after_recovery = time.monotonic()
                if self._pending_grow and not self.shutting_down:
                    # a rejoin admitted while the recovery was in flight:
                    # the world is consistent again, grow now
                    self._execute_grow(self._pending_grow.pop(0))
            elif "deploy_s" not in self.report:
                self.report["deploy_s"] = \
                    time.monotonic() - self.report.pop("deploy_start_s")

    def _last_recover_start(self):
        ev = self.report["events"][-1] if self.report["events"] else None
        return ev.get("t_recover_start") if ev else None

    def run(self) -> dict:
        if self.args.mode == "replica":
            self._spawn_standby()
        self.deploy()
        if self.args.mode == "replica":
            self._deploy_shadows()
        t_start = time.monotonic()
        self._first_barrier_after_recovery = None
        self._pending_respawn = set()
        self._serve()
        return self._finish(t_start)

    def _serve(self):
        # with the stall watchdog armed the event wait ticks so silent
        # ranks are noticed; either way 120 s without any event at all is
        # a dead cluster
        tick = 0.5 if self.stall_timeout > 0 else 120.0
        last_event = time.monotonic()
        while len(self.done) < len(self.world_ranks):
            try:
                kind, payload = self.events.get(timeout=tick)
            except queue.Empty:
                if time.monotonic() - last_event > 120:
                    raise TimeoutError("cluster stalled")
                self._check_stalls()
                continue
            last_event = time.monotonic()
            if kind == "channel_broken":
                node, conn = payload
                if (not self.shutting_down
                        and node in self.view.children
                        and self.daemon_socks.get(node) is conn):
                    self._handle_failure(FailureEvent(
                        kind=FailureType.NODE, node=node))
                continue
            msg = payload
            t = msg["type"]
            if t == "REGISTER_DAEMON":
                # post-deployment registration = REJOIN of a repaired
                # node (the initial deployment consumes its
                # registrations inside deploy()) — or a daemon re-homing
                # to this standby after the primary root died: ask its
                # workers to re-send any in-flight sync message the dead
                # root swallowed
                node = msg["node"]
                if self._standby_active and msg.get("rehome"):
                    sock = self.daemon_socks.get(node)
                    if sock is not None:
                        try:
                            send_msg(sock, {"type": "RESYNC"})
                        except OSError:
                            pass
                    for e in reversed(self.report["events"]):
                        if e.get("standby_takeover"):
                            # takeover latency: primary loss -> first
                            # daemon re-homed to this standby
                            e.setdefault("takeover_s", time.monotonic()
                                         - e["detect_at_s"])
                            break
                elif self.elastic is not None and node in self._rejoining:
                    self._rejoining.discard(node)
                    self._handle_rejoin(node)
            elif t == "REGISTER_WORKER":
                if msg.get("shadow"):
                    # a warm shadow came up: record its peer listener and
                    # rebroadcast the table so its primary starts
                    # streaming frames to it
                    self.shadow_table[msg["rank"]] = ("127.0.0.1",
                                                      msg["peer_port"])
                    self._shadow_pids[msg["rank"]] = msg.get("pid")
                    self._shadow_parent[msg["rank"]] = msg["node"]
                    self._await_shadows.discard(msg["rank"])
                    self._maybe_broadcast_table()
                else:
                    self.rank_table[msg["rank"]] = ("127.0.0.1",
                                                    msg["peer_port"])
                    self._rank_pids[msg["rank"]] = msg.get("pid")
                    self._pending_respawn.discard(msg["rank"])
                    self._maybe_broadcast_table()
            elif t == "CHILD_DEAD":
                # a death report for a pid that is not the rank's current
                # incarnation is stale (old pid of a re-registered rank,
                # or a straggler from a torn-down deployment) — drop it
                pid, known = msg.get("pid"), self._rank_pids.get(msg["rank"])
                stale = None not in (pid, known) and pid != known
                if pid is not None \
                        and pid == self._shadow_pids.get(msg["rank"]):
                    # an un-promoted shadow died, not the rank itself
                    self._handle_shadow_death(msg["rank"])
                elif self.shutting_down or stale:
                    pass
                elif not self.recovering:
                    if msg["rank"] in self._promote_inflight:
                        self._promote_window_death(msg["rank"])
                    elif self._join_open and known is not None \
                            and msg["rank"] in self.world_ranks:
                        # died inside the open rejoin window (after the
                        # table rebroadcast, before the consensus
                        # released): a cascade of the recovery still in
                        # flight — merge it, don't open a new recovery
                        # (the elastic path would otherwise drop a
                        # replacement that survivors are blocked waiting
                        # on)
                        self._respawn_during_recovery(msg["rank"])
                    else:
                        self._handle_failure(FailureEvent(
                            kind=FailureType.PROCESS, rank=msg["rank"]))
                elif known is not None:
                    # cascading failure mid-recovery: fold into the
                    # in-flight recovery instead of dropping it (a
                    # dropped death would stall the rejoin forever).
                    # known=None means the rank never registered in this
                    # world — a straggler report from a torn-down
                    # deployment, not a cascade.
                    self._respawn_during_recovery(msg["rank"])
            elif t == "BARRIER":
                self._barrier_arrive(msg)
            elif t == "FENCE":
                self._fence_arrive(msg)
            elif t == "REINIT_DONE":
                ev = self.report["events"][-1] if self.report["events"] \
                    else None
                t0 = self._last_recover_start()
                if ev is not None and t0 is not None:
                    ev["respawn_done_s"] = time.monotonic() - t0
            elif t == "JOIN":
                self._join_arrive(msg)
            elif t == "PROMOTE_NACK":
                self._promote_nack(msg)
            elif t == "SUSPECT":
                self._handle_suspect(msg)
            elif t == "SUSPECT_NODE":
                self._handle_suspect_node(msg)
            elif t == "DONE":
                self.done.add(msg["rank"])
                self.report.setdefault("checksums", {})[str(msg["rank"])] \
                    = msg["checksum"]
                # the incarnation that finished: its kernel launches and
                # start-up times (a respawned rank reports its own)
                self.report.setdefault("workers", {})[str(msg["rank"])] = {
                    k: msg[k] for k in ("launches", "startup", "restarted")
                    if k in msg}
            self._sync_standby()

    def _finish(self, t_start: float) -> dict:
        self.shutting_down = True
        self.report["total_s"] = time.monotonic() - t_start
        self._broadcast({"type": "SHUTDOWN"})
        # join on the daemons' exits instead of a fixed drain sleep: each
        # daemon exits once its workers are gone, so a clean shutdown
        # costs exactly the teardown latency, not a worst-case timer
        for p in self.daemon_procs.values():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.terminate()
                try:
                    p.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    p.kill()
        if self.args.report:
            # tmp + atomic rename: the scenario engine (and any external
            # watcher) takes the file's existence as completion — a
            # standby takeover hands off through exactly this commit
            tmp = self.args.report + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.report, f, indent=2)
            os.replace(tmp, self.args.report)
        with self._standby_lock:
            standby = self.standby_sock
        if standby is not None:
            try:
                send_msg(standby, {"type": "SHUTDOWN_STANDBY"})
            except OSError:
                pass
        if self.standby_proc is not None:
            try:
                self.standby_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.standby_proc.kill()
        return self.report

    # ----------------------------------------------------- standby root

    def _apply_sync(self, msg: dict):
        self.epoch = msg["epoch"]
        self.world_ranks = set(msg["world"])
        self.rank_table = {int(k): tuple(v)
                           for k, v in msg["table"].items()}
        self._rank_pids = {int(k): v for k, v in msg["pids"].items()}
        self.shadow_table = {int(k): tuple(v)
                             for k, v in msg["shadows"].items()}
        self._shadow_parent = {int(k): v
                               for k, v in msg["shadow_parent"].items()}
        self._shadow_pids = {int(k): v
                             for k, v in msg["shadow_pids"].items()}
        self.view.children = {d: set(rs)
                              for d, rs in msg["children"].items()}
        self.view.epoch = msg["view_epoch"]
        self.done = set(msg["done"])
        self.report = msg["report"]

    def run_standby(self) -> dict:
        """Warm-standby protocol: register with the primary, mirror its
        table/membership/report stream, and on primary loss take over —
        daemons re-home here, in-flight sync messages are re-requested
        (RESYNC), and this process finishes the job and commits the
        report the dead primary never could. A clean SHUTDOWN_STANDBY
        from the primary exits quietly instead. Returns {} when no
        takeover happened."""
        s = connect("127.0.0.1", self.args.primary_port)
        send_msg(s, {"type": "STANDBY_REGISTER", "port": self.port,
                     "pid": os.getpid()})
        synced = False
        while True:
            try:
                msg = recv_msg(s)
            except OSError:
                msg = None
            if msg is None:
                break                        # primary died mid-job
            if msg["type"] == "SHUTDOWN_STANDBY":
                return {}
            if msg["type"] == "SYNC":
                self._apply_sync(msg)
                synced = True
        if not synced or self.shutting_down:
            return {}
        # --- takeover
        self._standby_active = True
        t0 = time.monotonic()
        self.report.setdefault("events", []).append(
            {"failure": "root", "kind": "root", "detected_by": "standby",
             "standby_takeover": True, "detect_at_s": t0})
        self._first_barrier_after_recovery = None
        self._pending_respawn = set()
        self._serve()
        return self._finish(t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--ranks-per-node", type=int, default=4)
    ap.add_argument("--spares", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--fail-step", type=int, default=-1)
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--fail-kind", default="process",
                    choices=["process", "node"])
    ap.add_argument("--mode", default="reinit", choices=list(MODES))
    ap.add_argument("--min-data-parallel", type=int, default=1,
                    help="elastic world floor, in whole node groups: "
                         "shrink refuses to drop below "
                         "min_data_parallel * ranks_per_node ranks")
    ap.add_argument("--scenario", default="",
                    help="declarative Scenario JSON driving fault "
                         "injection (supersedes the --fail-* flags)")
    ap.add_argument("--stall-timeout", type=float, default=0.0,
                    help="arm the stall watchdog: a barrier stuck this "
                         "many seconds gets its missing ranks killed")
    ap.add_argument("--hb-period", type=float, default=0.0,
                    help="arm the worker neighbour-heartbeat ring: each "
                         "rank observes its ring successor this often")
    ap.add_argument("--hb-timeout", type=float, default=0.0,
                    help="consecutive heartbeat silence before the "
                         "observer reports SUSPECT to the root")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--report", default="")
    ap.add_argument("--pythonpath", default=os.environ.get("PYTHONPATH", ""))
    ap.add_argument("--as-standby", action="store_true",
                    help="run as the warm-standby root: mirror the "
                         "primary's tables and take over on its loss")
    ap.add_argument("--primary-port", type=int, default=0,
                    help="primary root's listener (standby mode only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the workers' state: cuda "
                         "unless cpu is asked for")
    args = ap.parse_args(argv)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    if args.device.startswith("cuda") and not args.as_standby:
        # build the workers' checksum kernel library once, here, so no
        # worker runs nvcc (compiled, not loaded: no CUDA in the root)
        from repro_torch.kernels.checksum._build import KERNELS
        KERNELS.build()
    if args.as_standby:
        rep = Root(args).run_standby()
        if not rep:
            return 0            # clean primary finish: nothing to do
        print(json.dumps(rep, indent=2))
        return 0
    rep = Root(args).run()
    ok = len(set(rep.get("checksums", {}).values())) >= 1
    print(json.dumps(rep, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
