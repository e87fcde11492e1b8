"""Worker process: the resilient MPI-rank analogue.

Runs `reinit_main` around a BSP compute loop (numpy matmul + tree
allreduce through the daemon/root control plane — the world communicator).
Checkpoints after every iteration: a local in-memory copy plus a push to
the buddy rank's peer socket (memory scheme), and a file checkpoint (file
scheme) — exactly Table 2's matrix.

Fault injection (paper §4): at the pre-drawn (step, rank), the victim
SIGKILLs itself (process failure) or asks its daemon to take the whole node
down (node failure). Survivors receive SIGREINIT (SIGUSR1), roll back to
the reinit point, and rejoin the epoch barrier with re-spawned ranks.

Replica mode adds a shadow role (--shadow): the process registers,
receives the primary's per-step checkpoint stream on its peer listener,
and parks outside the BSP loop until the root PROMOTEs it — it then
composes the warm frame for the resume step and enters the loop in the
dead primary's place, with zero rollback and zero respawn.

The port's worker keeps the rank's state on a torch device, the card
unless `--device cpu` is asked for, and is the only module of the
runtime that imports torch. Before it first registers with its daemon it
creates its CUDA context, allocates the model `w = 0.999·I` (float64,
dim x dim) on the card, loads the checksum kernel library and runs one
warm step, so a re-spawned rank's start-up cost lands in the recovery
time it causes, and a promoted shadow is warm. A
survivor rolls back with its context and its device buffers intact.
`x` lives on the device: the step is a float64 `torch.mv`, each step's
frame is digested on the device by K1 (`tile_checksums_kernel`) through
`FramePublisher`, and the sums that leave the rank (the allreduce value
and the DONE checksum) are numpy's pairwise `np.sum` of the host copy, so
every number and frame byte equals the JAX package's numpy worker. The
peer, heartbeat and control threads never touch the device.
"""
from __future__ import annotations

import time

_T_START = time.monotonic()     # before torch is imported

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.events import RankState
from repro_torch.core.membership import RankMembership
from repro_torch.core.reinit import ROLLBACK, RollbackSignal, install_sigreinit, \
    reinit_main
from repro_torch.checkpoint import serde
from repro_torch.checkpoint.memory_ckpt import BuddyStore
from repro_torch.scenarios import hooks
from repro_torch.scenarios.schema import Fault, Scenario, gray_delay_s
from repro_torch.device import resolve
from repro_torch.kernels.checksum import ops as checksum_ops
from repro_torch.kernels.checksum._build import KERNELS

from .transport import connect, install_lossy, listener, recv_msg, send_msg

_T_IMPORTED = time.monotonic()


class WorkerInjector:
    """Executes this rank's share of a Scenario at the named interruption
    points (installed as the process-global hook target; see
    repro_torch.scenarios.hooks). Each fault fires exactly once per *run* — an
    O_EXCL sentinel in the shared checkpoint dir survives respawns, so a
    restarted incarnation never re-kills itself.

    Faults at point="step" die behind the FENCE kill barrier (the root
    releases it once every other rank has committed that step's
    checkpoint), making the post-recovery consistent cut deterministic;
    phase-point faults interrupt the checkpoint/recovery machinery at
    their natural program point and rely on the rollback consensus."""

    def __init__(self, worker, plan: list):
        self.w = worker
        self.plan = plan                      # [(fault_index, Fault)]

    def __call__(self, point: str, step=None, **ctx):
        for idx, f in self.plan:
            if f.point != point:
                continue
            if f.step is not None and step is not None and f.step != step:
                continue
            if self._claim(idx, point, step):
                self._execute(f, step)

    def _claim(self, idx: int, point: str, step) -> bool:
        sentinel = os.path.join(self.w.ckpt_dir, f"INJECTED_f{idx}")
        try:
            fd = os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.write(fd, f"rank={self.w.rank} point={point} "
                     f"step={step}".encode())
        os.close(fd)
        return True

    def _fence(self, step):
        if step is None:
            return
        w = self.w
        try:
            w._send_daemon({"type": "FENCE", "rank": w.rank,
                            "epoch": w.epoch, "step": step})
            w._wait_release(("fence", step), w.epoch, timeout=60.0)
        except (RollbackSignal, TimeoutError, OSError):
            pass          # recovery already racing us: die anyway

    def _execute(self, f: Fault, step):
        w = self.w
        if f.point == "step":
            self._fence(step)
        if f.target == "node":
            # the victim signals its parent daemon (paper §4): SIGKILL
            # takes the node down silently, a channel break partitions
            # it (the fail-stop node then fences itself), and a hang
            # mutes the whole node — daemon and children — while every
            # channel stays open (only daemon-ring observation sees it)
            msg = {"channel_break": {"type": "BREAK_CHANNEL"},
                   "hang": {"type": "HANG_NODE"}}.get(
                       f.how, {"type": "KILL_NODE"})
            try:
                w._send_daemon(msg)
            except OSError:
                pass
            time.sleep(10)
            os.kill(os.getpid(), signal.SIGKILL)
        if f.how == "hang":
            # silent forever: no SIGCHLD, control channel intact. Going
            # silent includes the peer fabric (heartbeat ACKs stop), so
            # the neighbour ring — when armed — can SUSPECT us; without
            # it only the stall watchdog sees this
            w._silent.set()
            threading.Event().wait()
            return
        if f.how == "channel_break":
            # shutdown (not just close): wakes the control loop blocked
            # in recv with an EOF — it then exits the fail-stop rank
            try:
                w.daemon_sock.shutdown(socket.SHUT_RDWR)
                w.daemon_sock.close()
            except OSError:
                pass
            threading.Event().wait()
            return
        os.kill(os.getpid(), signal.SIGKILL)


class Worker:
    # buddy frames chain deltas against the previous step's push; a full
    # base every 2nd step keeps chains shorter than the retention window
    PUSH_BASE_EVERY = 2

    def __init__(self, args):
        self.rank = args.rank
        self.dim = args.dim
        self._setup_device(args.device)
        # membership as rank ids, not a count (a shrinking recovery
        # leaves a non-contiguous surviving set), adopted only from the
        # root's broadcasts — centralized in core.membership
        self.member = RankMembership(rank=args.rank,
                                     world_ranks=list(range(args.world)),
                                     epoch=args.epoch,
                                     initial_world=args.world)
        # steps this rank keeps exempt from checkpoint retention while
        # the world is shrunk: the consistent cut a grow-back resumes
        # from (re-written as a composable full frame at pin time).
        # Released pins (world fully re-expanded) are reaped once they
        # age past the retention window — never before the post-grow
        # restore that reads them.
        self._pinned: set[int] = set()           # guarded-by: barrier_cv
        self._released_pins: set[int] = set()    # guarded-by: barrier_cv
        self.steps = args.steps
        self.ckpt_dir = args.ckpt_dir
        # armed by a hang injection: the rank stops answering everything
        # (peer fabric included) while its channels stay open
        self._silent = threading.Event()
        self.injector = WorkerInjector(self, self._injection_plan(args))
        hooks.install(self.injector)
        self.initial_state = (RankState.RESTARTED if args.restarted
                              else RankState.NEW)

        # replica mode: shadow role + the primary side of the stream.
        # shadow_table maps rank -> its shadow's peer address (from the
        # root's RANK_TABLE broadcasts); a primary pushes every step's
        # frame there. _pending_sync is the in-flight root-bound message
        # (BARRIER/JOIN/DONE) replayed on RESYNC after a standby
        # takeover — the primary root may have died with it buffered but
        # unprocessed.
        self.is_shadow = getattr(args, "shadow", False)
        self.shadow_table: dict[int, tuple[str, int]] = {}
        self._shadow_addr_seen: Optional[tuple] = None
        self._pending_sync: Optional[dict] = None   # guarded-by: barrier_cv
        self._promote_ev = threading.Event()
        self._promote_resume = 0
        self._promoted = False
        self._shadow_plan = (
            Scenario.load(args.scenario).shadow_faults(self.rank)
            if (args.scenario and self.is_shadow) else [])

        # gray-failure plan: this rank's slow/lossy degradations. Only
        # the original incarnation degrades — a drained-and-respawned
        # rank (--restarted) comes back healthy, which is what lets the
        # mitigation path actually cure a persistent straggler.
        self._gray_plan = (
            Scenario.load(args.scenario).gray_faults_for_rank(self.rank)
            if (args.scenario and not args.restarted) else [])
        self._lossy_armed = False

        # retention window spills to local disk past the hot step — the
        # paper's memory/file dichotomy as an LRU tier, exercised by the
        # real-process runtime on every run. Prior incarnations of this
        # rank (pre-respawn) are dead by the time we start: reap their
        # orphaned spill dirs.
        spill_prefix = f".spill_r{self.rank}_"
        try:
            for name in os.listdir(self.ckpt_dir):
                if name.startswith(spill_prefix) \
                        and name != spill_prefix + str(os.getpid()):
                    shutil.rmtree(os.path.join(self.ckpt_dir, name),
                                  ignore_errors=True)
        except OSError:
            pass
        self.store = BuddyStore(
            self.rank, self.world, push_remote=self._push_remote,
            spill_dir=os.path.join(self.ckpt_dir,
                                   spill_prefix + str(os.getpid())),
            hot_steps=1)
        # buddy frame cadence shared with FileCheckpointer's policy;
        # contiguous: BuddyStore's retention walk assumes step-1 chains
        self._publisher = serde.FramePublisher(self.PUSH_BASE_EVERY,
                                               contiguous=True)
        self.rank_table: dict[int, tuple[str, int]] = {}
        self.table_event = threading.Event()
        self.barrier_release: dict[tuple[int, int], float] = {}  # guarded-by: barrier_cv
        self.barrier_cv = threading.Condition()

        # peer listener (buddy checkpoint fabric)
        self.peer_sock = listener()
        self.peer_port = self.peer_sock.getsockname()[1]
        threading.Thread(target=self._peer_loop, daemon=True).start()

        # control channel to parent daemon; the send lock serializes the
        # main loop's sends against the heartbeat observer thread's
        # SUSPECT reports (two concurrent sendall()s would interleave)
        self.daemon_sock = connect("127.0.0.1", args.daemon_port)
        self._daemon_send_lock = threading.Lock()
        self._send_daemon({
            "type": "REGISTER_WORKER", "rank": self.rank,
            "peer_port": self.peer_port, "pid": os.getpid(),
            "restarted": args.restarted, "shadow": self.is_shadow})
        threading.Thread(target=self._control_loop, daemon=True).start()

        # neighbour-heartbeat ring (ULFM/FTHP-MPI-style): observe the ring
        # successor every period; after `timeout` of consecutive silence
        # report SUSPECT to the root — hang detection without a watchdog
        self.hb_period = getattr(args, "hb_period", 0.0)
        self.hb_timeout = getattr(args, "hb_timeout", 0.0)
        if self.hb_period > 0 and self.hb_timeout > 0:
            threading.Thread(target=self._hb_loop, daemon=True).start()

    def _setup_device(self, device: str):
        """Everything a rank needs on its device before it may register:
        the CUDA context, the fixed model `w`, the checksum kernel
        library (built by the launcher; loaded here) and a warm step.
        Times each part into `self.startup` (seconds), which DONE
        reports."""
        t0 = time.monotonic()
        self.device = resolve(device)
        torch.set_num_threads(1)        # one core a rank, as under MPI
        cuda = self.device.type == "cuda"
        if cuda:
            torch.zeros(1, device=self.device)      # creates the context
            torch.cuda.synchronize(self.device)
        t1 = time.monotonic()
        # fixed "model", the reference's np.eye(dim) * 0.999 (scaled in
        # place: one dim x dim buffer, not two)
        self.w = torch.eye(self.dim, dtype=torch.float64,
                           device=self.device).mul_(0.999)
        if cuda:
            torch.cuda.synchronize(self.device)
        t2 = time.monotonic()
        if cuda:
            KERNELS.lib()
        t3 = time.monotonic()
        # one step's device work on zeros (the cuBLAS handle, the first
        # kernels' loading), so that a warm shadow's promotion or a
        # respawned rank's first step does not pay it; no K1 launch
        torch.mv(self.w, torch.zeros(self.dim, dtype=torch.float64,
                                     device=self.device)).add_(1e-3).cpu()
        t4 = time.monotonic()
        self.startup = {"import_s": _T_IMPORTED - _T_START,
                        "context_s": t1 - t0, "state_s": t2 - t1,
                        "kernel_lib_s": t3 - t2, "warm_s": t4 - t3,
                        "ready_s": t4 - _T_START}
        if cuda:
            self.startup["reserved_mib"] = \
                torch.cuda.memory_reserved(self.device) / 2**20

    # ------------------------------------------------- membership facade

    @property
    def world_ranks(self) -> list:
        return self.member.world_ranks

    @world_ranks.setter
    def world_ranks(self, ranks):
        self.member.adopt(world=ranks)

    @property
    def world(self) -> int:
        return self.member.size

    @property
    def epoch(self) -> int:
        return self.member.epoch

    @epoch.setter
    def epoch(self, value: int):
        self.member.adopt(epoch=value)

    def _send_daemon(self, msg: dict):
        with self._daemon_send_lock:
            send_msg(self.daemon_sock, msg)

    def _injection_plan(self, args) -> list:
        """This rank's (index, Fault) pairs — from a scenario file when
        given, else synthesized from the legacy --fail-* flags (the
        original single-kill-point injection, now one schema entry)."""
        if args.scenario:
            return Scenario.load(args.scenario).faults_for_rank(self.rank)
        if args.fail_step >= 0 and args.fail_rank == self.rank:
            target = "node" if args.fail_kind == "node" else "rank"
            return [(0, Fault(target, self.rank, args.fail_step))]
        return []

    # ------------------------------------------------------------ fabric

    def _peer_loop(self):
        while True:
            try:
                conn, _ = self.peer_sock.accept()
            except OSError:
                return
            threading.Thread(target=self._peer_conn, args=(conn,),
                             daemon=True).start()

    def _peer_conn(self, conn):
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                if self._silent.is_set():
                    return          # hung rank: answers nothing, to anyone
                if msg["type"] == "HB_PING":
                    send_msg(conn, {"type": "HB_ACK", "rank": self.rank})
                elif msg["type"] == "PUSH_CKPT":
                    self.store.hold(msg["origin"], msg["step"],
                                    msg["_payload"])
                    send_msg(conn, {"type": "ACK"})
                    if self._shadow_plan and msg["origin"] == self.rank:
                        self._shadow_stream_fault(msg["step"])
                elif msg["type"] == "GET_CKPT":
                    held = self.store.held_map(msg["origin"])
                    # all retained frames concatenated on the raw payload
                    # channel; the index maps step -> (offset, length)
                    index, blobs, off = {}, [], 0
                    for s, b in held.items():
                        index[str(s)] = [off, len(b)]
                        blobs.append(b)
                        off += len(b)
                    send_msg(conn, {"type": "CKPT", "steps": index},
                             payload=b"".join(blobs))
        finally:
            conn.close()

    def _shadow_stream_fault(self, step: int):
        """Shadow-target faults fire off the replication stream: once the
        primary's push reaches the fault's step, the warm standby itself
        dies — exercising the root's shadow-loss bookkeeping (drop the
        entry, fall back to reinit if the primary dies later)."""
        for idx, f in self._shadow_plan:
            if f.step is not None and step < f.step:
                continue
            if self.injector._claim(idx, "shadow.stream", step):
                os.kill(os.getpid(), signal.SIGKILL)

    def _push_shadow(self, step: int, payload: bytes, x: torch.Tensor):
        """Primary side of the replication stream: mirror every step's
        frame to this rank's shadow (when one exists). The first frame a
        newly-seen shadow receives must be self-contained — the shadow
        joined mid-chain, so a delta against a frame it never got would
        leave its whole stream uncomposable."""
        addr = self.shadow_table.get(self.rank)
        if addr is None:
            return
        if addr != self._shadow_addr_seen:
            payload = serde.to_bytes({"x": x}, extra={"step": step})
        try:
            s = connect(*addr, timeout=5)
            send_msg(s, {"type": "PUSH_CKPT", "origin": self.rank,
                         "step": step}, payload=payload)
            recv_msg(s)
            s.close()
            self._shadow_addr_seen = addr
        except OSError:
            pass      # shadow died; the root drops it from the table

    def _push_remote(self, buddy_rank: int, step: int, payload: bytes):
        addr = self.rank_table.get(buddy_rank)
        if addr is None:
            return
        try:
            s = connect(*addr, timeout=5)
            send_msg(s, {"type": "PUSH_CKPT", "origin": self.rank,
                         "step": step}, payload=payload)
            recv_msg(s)
            s.close()
        except OSError:
            pass      # buddy died; the failure path will handle it

    def _hb_loop(self):
        """Heartbeat observer: ping the ring successor's peer listener
        every period; `timeout` seconds of consecutive misses raise a
        SUSPECT to the root (via the daemon relay). Misses during an
        epoch transition are discarded — recovery re-forms the ring and
        the table rebroadcast resets the observation."""
        missed = 0.0
        while True:
            time.sleep(self.hb_period)
            if self._silent.is_set():
                return
            ring = list(self.world_ranks)
            if len(ring) < 2 or self.rank not in ring:
                continue
            succ = ring[(ring.index(self.rank) + 1) % len(ring)]
            addr = self.rank_table.get(succ)
            epoch0 = self.epoch
            if addr is None:
                missed = 0.0            # table in flux (deploy/recovery)
                continue
            ok = False
            try:
                s = connect(*addr, timeout=self.hb_period)
                s.settimeout(max(self.hb_period, 0.05))
                send_msg(s, {"type": "HB_PING", "from": self.rank})
                ok = recv_msg(s) is not None
                s.close()
            except OSError:
                ok = False
            if ok:
                missed = 0.0
            elif self.epoch == epoch0:
                missed += self.hb_period
                if missed >= self.hb_timeout:
                    try:
                        self._send_daemon({"type": "SUSPECT", "rank": succ,
                                           "by": self.rank,
                                           "epoch": epoch0})
                    except OSError:
                        pass
                    missed = 0.0
            else:
                missed = 0.0            # epoch moved: stale observation

    def _pull_from_buddy(self) -> dict[int, bytes]:
        """All retained checkpoints the buddy holds for this rank."""
        addr = self.rank_table.get(self.store.buddy)
        if addr is None:
            return {}
        try:
            s = connect(*addr, timeout=5)
            send_msg(s, {"type": "GET_CKPT", "origin": self.rank})
            msg = recv_msg(s)
            s.close()
            if msg:
                blob = msg.get("_payload", b"")
                return {int(k): blob[off:off + n]
                        for k, (off, n) in msg.get("steps", {}).items()}
        except OSError:
            pass
        return {}

    # ----------------------------------------------------------- control

    def _control_loop(self):
        while True:
            try:
                msg = recv_msg(self.daemon_sock)
            except OSError:       # channel broken (possibly by injection)
                msg = None
            if msg is None:
                os._exit(3)       # daemon died under us: node is gone
            t = msg["type"]
            if t == "RANK_TABLE":
                self.rank_table = {int(k): tuple(v)
                                   for k, v in msg["table"].items()}
                self.shadow_table = {int(k): tuple(v)
                                     for k, v in
                                     msg.get("shadows", {}).items()}
                with self.barrier_cv:     # epoch bump unblocks stale waits
                    # the table carries the authoritative membership: a
                    # rank spawned into a shrunk/grown world learns its
                    # actual world here, not from its static --world arg
                    self.member.adopt(world=msg.get("world"),
                                      epoch=msg["epoch"])
                    self.barrier_cv.notify_all()
                self.table_event.set()
            elif t == "BARRIER_RELEASE":
                with self.barrier_cv:
                    self.barrier_release[(msg["epoch"], msg["step"])] = \
                        msg["value"]
                    self.barrier_cv.notify_all()
            elif t == "JOIN_RELEASE":
                with self.barrier_cv:
                    self.barrier_release[("join", msg["epoch"])] = \
                        msg["resume"]
                    self.barrier_cv.notify_all()
            elif t == "FENCE_RELEASE":
                with self.barrier_cv:
                    self.barrier_release[("fence", msg["step"])] = 1
                    self.barrier_cv.notify_all()
            elif t == "SHRINK":
                # elastic shrinking recovery: adopt the contracted world
                # (membership + epoch), drop dead table entries, and
                # re-form the buddy ring over survivors. The SIGREINIT
                # the daemon delivered alongside unwinds the main loop;
                # it rejoins under the new epoch and re-balances (the
                # allreduce mean below runs over the shrunk world).
                with self.barrier_cv:
                    self.member.adopt(world=msg["world"],
                                      epoch=msg["epoch"])
                    for r in list(self.rank_table):
                        if r not in self.world_ranks:
                            self.rank_table.pop(r, None)
                    self.barrier_cv.notify_all()
                self.store.reform_ring(self.world_ranks)
            elif t == "GROW":
                # grow-back: a repaired node rejoined and the root
                # re-admitted the dropped ranks. Adopt the re-expanded
                # membership (bumped epoch + mesh epoch), release the
                # pinned grow anchors (the consensus about to run
                # supersedes them), and re-form the buddy ring over the
                # full world — the SIGREINIT alongside unwinds the main
                # loop back to the pinned pre-shrink cut.
                with self.barrier_cv:
                    self.member.adopt(world=msg["world"],
                                      epoch=msg["epoch"])
                    if not self.member.shrunk:
                        # fully re-expanded: the anchors are consumed
                        # (a partially-grown world keeps them — older
                        # drops still need their cuts durable). Reaped
                        # by retention once they age out, not here: the
                        # post-grow restore still reads them.
                        self._released_pins |= self._pinned
                        self._pinned.clear()
                    self.barrier_cv.notify_all()
                self.store.reform_ring(self.world_ranks)
            elif t == "PROMOTE":
                # replica failover: the root names this shadow the new
                # primary for its rank. Accept only if the warm stream
                # actually composes at the resume step; otherwise NACK so
                # the root can fall back (kill us + reinit respawn).
                resume = int(msg["resume"])
                have = serde.composable_steps(
                    self.store.held_map(self.rank))
                if resume in have:
                    self._promote_resume = resume
                    self._promote_ev.set()
                else:
                    try:
                        self._send_daemon({
                            "type": "PROMOTE_NACK", "rank": self.rank,
                            "epoch": msg.get("epoch", self.epoch),
                            "have": sorted(have)})
                    except OSError:
                        pass
            elif t == "RESYNC":
                # standby takeover: the dead primary root may have
                # swallowed our in-flight BARRIER/JOIN/DONE (the send
                # "succeeded" into a socket buffer nobody drained) —
                # replay it; root-side arrival recording is idempotent
                with self.barrier_cv:
                    pending = (dict(self._pending_sync)
                               if self._pending_sync else None)
                if pending is not None:
                    try:
                        self._send_daemon(pending)
                    except OSError:
                        pass
            elif t == "SHUTDOWN":
                os._exit(0)

    def _wait_release(self, key, epoch, timeout: float = 120.0):
        """Event-driven wait: woken by the condition variable (releases,
        epoch bumps) or unwound instantly by SIGREINIT via the
        interruptible safe-point — no polling period on the recovery
        critical path."""
        deadline = time.monotonic() + timeout
        try:
            with self.barrier_cv:
                while key not in self.barrier_release:
                    ROLLBACK.check()
                    if self.epoch != epoch:   # recovered: new epoch
                        raise RollbackSignal(self.epoch)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"release {key}")
                    with ROLLBACK.interruptible():
                        self.barrier_cv.wait(min(remaining, 5.0))
                return self.barrier_release.pop(key)
        except RuntimeError as e:
            # SIGREINIT can land while Condition.wait is re-acquiring the
            # cv lock; the handler's RollbackSignal aborts the acquire
            # and the `with` exit then fails releasing an un-held lock,
            # surfacing as RuntimeError with the rollback swallowed.
            # The lock is un-held (future acquires are fine) — translate
            # exactly that case back into the rollback that caused it;
            # anything else is a real error and propagates.
            if "lock" not in str(e):
                raise
            ROLLBACK.clear()
            raise RollbackSignal(self.epoch)

    def _allreduce(self, step: int, value: float) -> float:
        """BSP collective: tree sum through daemon → root and back."""
        epoch = self.epoch
        msg = {"type": "BARRIER", "rank": self.rank, "epoch": epoch,
               "step": step, "value": value}
        with self.barrier_cv:
            self._pending_sync = msg
        self._send_daemon(msg)
        try:
            return self._wait_release((epoch, step), epoch)
        finally:
            with self.barrier_cv:
                self._pending_sync = None

    def _join(self, avail: int) -> int:
        """ORTE-style rejoin barrier (the MPI_Init-equivalent barrier of
        paper §3.2) extended with rollback consensus: every rank reports
        the newest checkpoint it can restore, the root answers with the
        minimum — the latest *consistent* global checkpoint."""
        epoch = self.epoch
        msg = {"type": "JOIN", "rank": self.rank, "epoch": epoch,
               "avail": avail}
        with self.barrier_cv:
            self._pending_sync = msg
        self._send_daemon(msg)
        try:
            return int(self._wait_release(("join", epoch), epoch))
        finally:
            with self.barrier_cv:
                self._pending_sync = None

    # --------------------------------------------------------------- app

    def _ckpt_payload(self, step: int, x: torch.Tensor) -> bytes:
        """Serde frame for this step — a tile-range delta against the
        previous step's frame when the state is sparse-dirty (redistribu-
        tion then moves only dirty bytes), a full frame otherwise or on
        every PUSH_BASE_EVERY-th step (chain anchor). The publisher
        digests the device `x` where it lives (K1 on the card)."""
        return self._publisher.publish({"x": x}, step)

    def _compose_state(self, frames: dict[int, bytes], step: int
                       ) -> tuple[int, torch.Tensor]:
        """Compose on the host, then upload (a copy of its own)."""
        extra, flat = serde.compose(frames, step)
        return int(extra["step"]), self._upload(flat["x"])

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(host)).to(self.device)

    def _file_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"rank_{self.rank}.s{step}.bin")

    def _save_file(self, step: int, payload: bytes):
        tmp = self._file_path(step) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        # mid-checkpoint-write interruption point: the bytes are on disk
        # but invisible — a kill here must leave step-1 the newest
        # loadable checkpoint
        hooks.fire("worker.ckpt.mid_write", step=step)
        os.replace(tmp, self._file_path(step))
        # retention: drop the aged-out step — unless it is a pinned grow
        # anchor (the consistent cut a shrunk world must keep durable so
        # a grow-back can resume from it). Pin state is shared with the
        # control thread's GROW arm, so read and reap it under the cv;
        # the unlinks happen outside (no IO under the lock).
        old_step = step - 3
        old = self._file_path(old_step)
        with self.barrier_cv:
            unpin = old_step not in self._pinned
            # reap released anchors once they age out of the window
            # (they were consumed by the grow's restore; leaving them
            # would grow the dir and every later recovery's restore
            # scan unboundedly)
            reap = [p for p in sorted(self._released_pins)
                    if p <= step - 3]
            self._released_pins.difference_update(reap)
        if unpin and os.path.exists(old):
            os.unlink(old)
        for s in reap:
            stale = self._file_path(s)
            if os.path.exists(stale):
                os.unlink(stale)

    def _pin_anchor(self, step: int, x: torch.Tensor):
        """While the world is shrunk, keep the consensus cut durable as
        the grow-back anchor: re-write it as a self-contained full frame
        (a delta frame's chain parents would age out of retention) and
        exempt it from the retention unlink until a GROW releases it."""
        with self.barrier_cv:
            if step in self._pinned:
                return
        tmp = self._file_path(step) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(serde.to_bytes({"x": x}, extra={"step": step}))
        os.replace(tmp, self._file_path(step))
        with self.barrier_cv:
            self._pinned.add(step)

    def _file_map(self) -> dict[int, bytes]:
        out = {}
        prefix = f"rank_{self.rank}.s"
        try:
            names = os.listdir(self.ckpt_dir)
        except FileNotFoundError:
            return out
        for name in names:
            if name.startswith(prefix) and name.endswith(".bin"):
                step = int(name[len(prefix):-4])
                with open(os.path.join(self.ckpt_dir, name), "rb") as f:
                    out[step] = f.read()
        return out

    def body(self, state: RankState) -> int:
        self.table_event.wait(30)     # need the rank table before buddy I/O
        # --- application recovery (Table 2): gather restorable checkpoints.
        # Maps merge file + memory tiers (identical frame bytes per step):
        # a rank that committed its file but died before the buddy push
        # still resumes from the committed step.
        if state is RankState.RESTARTED:
            avail_map = {**self._file_map(),      # file scheme (node)
                         **self._pull_from_buddy()}   # memory (process)
            if avail_map:
                hooks.fire("worker.recovery.pulled")
        elif state is RankState.REINITED:
            hooks.fire("worker.recovery.enter")   # survivor just rolled back
            avail_map = {**self._file_map(),
                         **self.store.local_map()}    # survivors: memory
        else:
            # NEW: resume from file if one exists — the CR re-deploy path
            avail_map = self._file_map()
            if avail_map:
                hooks.fire("worker.recovery.pulled")
        # --- consistent-cut consensus: resume at min over ranks; a step
        # counts as available only when its delta chain composes locally
        composable = serde.composable_steps(avail_map)
        resume = self._join(max(composable, default=0))
        if resume > 0:
            if resume not in composable:
                raise RuntimeError(
                    f"rank {self.rank}: no ckpt for agreed step {resume}; "
                    f"have {sorted(composable)}")
            hooks.fire("worker.recovery.compose", step=resume)
            start, x = self._compose_state(avail_map, resume)
        else:
            start = 0
            rng = np.random.default_rng(self.rank)
            x = self._upload(rng.standard_normal(self.dim))
        # a shrunk world pins its cut: the dropped ranks' newest durable
        # checkpoints are at this step, so a future grow-back's consensus
        # lands exactly here — keep it composable and retention-proof
        if self.member.shrunk and resume > 0:
            self._pin_anchor(resume, x)
        return self._loop(start, x)

    def _gray_degrade(self, step: int):
        """Apply this rank's active gray faults for the step. `slow`
        sleeps the deceleration delay before compute — the rank still
        does all the work, just late, so state stays bit-identical.
        `lossy` arms the seeded transport degradation once, at the
        fault's onset step, scoped to the daemon uplink (one bad link):
        every control-plane send then pays a delay, a seeded fraction
        doubled. Both surface at the root as barrier lateness
        attributable to exactly this rank."""
        for idx, f in self._gray_plan:
            if step < f.step:
                continue
            if f.how == "slow":
                time.sleep(gray_delay_s(f))
            elif f.how == "lossy" and not self._lossy_armed:
                install_lossy(seed=1000 + 64 * idx + self.rank,
                              delay_s=gray_delay_s(f),
                              sock=self.daemon_sock)
                self._lossy_armed = True

    def _loop(self, start: int, x: torch.Tensor) -> None:
        """The BSP step loop proper. Reached via `body` (normal join /
        rollback path) or directly by a promoted shadow, which skips the
        consensus entirely — its warm frame IS the resume state."""
        w = self.w                          # fixed "model", on the device

        for step in range(start, self.steps):
            ROLLBACK.check()
            # scenario injection — each fault fires exactly once per run
            # (the injector's O_EXCL sentinel stops re-spawned/restarted
            # processes from re-killing themselves). Step-point faults
            # wait behind the FENCE (deterministic kill barrier): the
            # root releases it once every other rank has arrived at this
            # step's barrier — i.e. has committed its checkpoint for this
            # step — so the post-recovery consistent cut is always
            # exactly `step`, independent of scheduling around SIGKILL.
            hooks.fire("step", step=step)
            self._gray_degrade(step)
            # BSP compute + collective
            # w is 0.999·I: every output is 0.999·x_i plus exact zeros,
            # so any order of summation gives numpy's bits
            x = torch.mv(w, x) + 1e-3
            # numpy's pairwise sum of the host copy: the reference's bits
            total = self._allreduce(step, float(np.sum(x.cpu().numpy())))
            x[0] = total / self.world       # interlocked dependency
            # checkpoint: file first, then memory (local+buddy) — the
            # store's spill tier references the rank file already on
            # disk instead of writing the same bytes twice
            payload = self._ckpt_payload(step + 1, x)
            self._save_file(step + 1, payload)
            # mid-replication interruption point (ReStore): the file is
            # committed but the buddy never receives this step
            hooks.fire("worker.ckpt.pre_push", step=step + 1)
            self.store.save(step + 1, payload,
                            on_disk=self._file_path(step + 1))
            self._push_shadow(step + 1, payload, x)
        msg = {"type": "DONE", "rank": self.rank,
               "checksum": float(np.sum(x.cpu().numpy())),
               "launches": dict(checksum_ops.LAUNCHES),
               "startup": self.startup,
               "restarted": self.initial_state is RankState.RESTARTED}
        with self.barrier_cv:
            self._pending_sync = msg     # replayed if a standby takes over
        self._send_daemon(msg)
        # park until SHUTDOWN (control loop exits the process) — an event
        # wait, not a poll loop
        threading.Event().wait()

    def _shadow_body(self, state: RankState) -> None:
        """Entry for a promoted shadow. The first pass (promotion itself)
        composes the warm frame and enters the loop at the resume step —
        no join, no rollback. If a *later* recovery SIGREINITs us, we are
        an ordinary survivor by then and take the normal body path."""
        if self._promoted:
            return self.body(state)
        # cascade window: the promoted-but-not-yet-running shadow is the
        # same program point a respawned rank hits when it pulls buddy
        # state — a fault planted there kills the new primary mid-promote
        hooks.fire("worker.recovery.pulled")
        resume = self._promote_resume
        frames = self.store.held_map(self.rank)
        hooks.fire("worker.recovery.compose", step=resume)
        _, x = self._compose_state(frames, resume)
        self._promoted = True
        return self._loop(resume, x)

    def run(self):
        install_sigreinit()
        if self.is_shadow:
            # warm standby: the peer listener is absorbing the primary's
            # stream; stay out of the BSP world until the root PROMOTEs
            # us. SIGREINITs from unrelated recoveries only arm the
            # deferred flag here (the wait is not an interruptible
            # region) — cleared before we take over.
            self._promote_ev.wait()
            ROLLBACK.clear()
            reinit_main(self._shadow_body, initial_state=RankState.NEW)
            return
        try:
            reinit_main(self.body, initial_state=self.initial_state)
        except SystemExit:
            raise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--daemon-port", type=int, required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--fail-step", type=int, default=-1)
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--fail-kind", default="process")
    ap.add_argument("--scenario", default="")
    ap.add_argument("--hb-period", type=float, default=0.0)
    ap.add_argument("--hb-timeout", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--restarted", action="store_true")
    ap.add_argument("--shadow", action="store_true")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the rank's state: cuda unless "
                         "cpu is asked for")
    # no set_deterministic() here: it costs seconds at start-up (on the
    # recovery path of a re-spawned rank), and nothing this rank computes
    # depends on an order of summation (see _loop)
    Worker(ap.parse_args(argv)).run()


if __name__ == "__main__":
    main()
