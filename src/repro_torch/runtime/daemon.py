"""Per-node daemon: spawn/monitor workers, relay faults, run Algorithm 2.

The daemon is the ORTE-daemon analogue: it spawns its children worker
processes, watches them with a waitpid loop (SIGCHLD semantics), relays
death notifications to the root, and on REINIT signals survivors with
SIGREINIT (SIGUSR1) and re-spawns the ranks assigned to it.

A KILL_NODE message (node-failure injection) SIGKILLs every child and then
the daemon itself — from the root's perspective the control channel breaks,
exactly like a node loss.

The port's copy: it spawns the port's workers (`repro_torch.runtime.worker`)
and passes `--device` on to them. It imports no torch, so a daemon starts
in the time the interpreter takes.

Replica mode extends the daemon with shadow hosting (a SPAWN carrying
shadow=True starts warm-shadow workers, PROMOTE is relayed to the named
one) and root fail-over: when the control channel to the root breaks and a
warm-standby address was configured (--standby-port), the daemon re-homes —
re-registers with the standby and continues relaying — instead of tearing
the node down.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from repro_torch.core.failure import ChildMonitor

from .transport import connect, listener, recv_msg, send_msg


class Daemon:
    def __init__(self, args):
        self.node = args.node
        self.args = args
        self.workers: dict[int, subprocess.Popen] = {}       # guarded-by: lock
        self.worker_socks: dict[int, object] = {}            # guarded-by: lock
        self.last_table: dict | None = None   # guarded-by: lock
        # guards the three shared maps above: mutated by per-connection
        # threads and the spawn fan-out, read by the run loop
        self.lock = threading.Lock()
        # serializes writes to worker sockets: the run loop broadcasts
        # while per-connection threads replay the cached table — two
        # concurrent sendall()s on one socket could interleave frames
        self.send_lock = threading.Lock()
        # armed by a node-hang injection: the daemon answers nothing
        # (worker relays, root messages, ring pings) while every channel
        # stays open — only daemon-level observation can see it
        self._silent = threading.Event()
        # daemon-ring observation (node-level heartbeat): node -> wport
        # of every live daemon, from the root's DAEMON_TABLE broadcasts
        self.daemon_table: dict[str, int] = {}

        self.monitor = ChildMonitor(self._on_child_death)
        self.monitor.start()

        # listener for workers (and for neighbour daemons' ring pings)
        self.wsock = listener()
        self.wport = self.wsock.getsockname()[1]
        threading.Thread(target=self._worker_accept_loop,
                         daemon=True).start()

        # control channel to root
        self.root_sock = connect("127.0.0.1", args.root_port)
        self.root_send_lock = threading.Lock()
        # warm-standby root (replica mode): where to re-home if the
        # primary's channel breaks. One re-home only — if the standby
        # dies too, the node goes down like any root loss.
        self.standby_port = int(getattr(args, "standby_port", 0) or 0)
        self._rehome_lock = threading.Lock()
        self._rehomed = False
        self._send_root({"type": "REGISTER_DAEMON", "node": self.node,
                         "pid": os.getpid(), "port": self.wport})

        # neighbour-heartbeat ring over *daemons*: observe the successor
        # daemon's listener every period; `timeout` of consecutive
        # silence reports SUSPECT_NODE to the root — a hung daemon (node
        # loss) is detected even though its control channel stays open
        self.hb_period = getattr(args, "hb_period", 0.0)
        self.hb_timeout = getattr(args, "hb_timeout", 0.0)
        if self.hb_period > 0 and self.hb_timeout > 0:
            threading.Thread(target=self._hb_loop, daemon=True).start()

    def _send_root(self, msg: dict):
        # serializes run-loop relays against the heartbeat observer's
        # SUSPECT_NODE reports (two concurrent sendall()s interleave)
        with self.root_send_lock:
            sock = self.root_sock
            try:
                send_msg(sock, msg)
                return
            except OSError:
                if not self._rehome(sock):
                    raise
            send_msg(self.root_sock, msg)

    def _rehome(self, failed_sock) -> bool:
        """Swap the root channel over to the warm standby. Returns True
        when self.root_sock is usable again (either this call re-homed,
        or another thread already did and `failed_sock` was stale)."""
        if self.standby_port <= 0:
            return False
        with self._rehome_lock:
            if self.root_sock is not failed_sock:
                return True        # raced: someone re-homed already
            if self._rehomed:
                return False       # standby is gone too
            try:
                sock = connect("127.0.0.1", self.standby_port)
                send_msg(sock, {"type": "REGISTER_DAEMON",
                                "node": self.node, "pid": os.getpid(),
                                "port": self.wport, "rehome": True})
            except OSError:
                self._rehomed = True
                return False
            self.root_sock = sock
            self._rehomed = True
            return True

    # ------------------------------------------------------------ workers

    def spawn_worker(self, rank: int, *, restarted: bool, epoch: int,
                     shadow: bool = False):
        a = self.args
        cmd = [sys.executable, "-m", "repro_torch.runtime.worker",
               "--rank", str(rank), "--world", str(a.world),
               "--daemon-port", str(self.wport),
               "--steps", str(a.steps), "--dim", str(a.dim),
               "--fail-step", str(a.fail_step),
               "--fail-rank", str(a.fail_rank),
               "--fail-kind", a.fail_kind,
               "--scenario", a.scenario,
               "--hb-period", str(getattr(a, "hb_period", 0.0)),
               "--hb-timeout", str(getattr(a, "hb_timeout", 0.0)),
               "--ckpt-dir", a.ckpt_dir,
               "--epoch", str(epoch), "--device", a.device]
        if restarted:
            cmd.append("--restarted")
        if shadow:
            cmd.append("--shadow")
        env = dict(os.environ, PYTHONPATH=a.pythonpath)
        proc = subprocess.Popen(cmd, env=env)
        with self.lock:
            self.workers[rank] = proc
        self.monitor.watch(rank, proc.pid)

    def _on_child_death(self, rank: int, pid: int, status: int):
        # SIGCHLD: relay to root (paper: daemon notifies, root decides).
        # The pid lets the root drop stale reports — a death of an old
        # incarnation must not be mistaken for the current one's.
        if self._silent.is_set():
            return
        try:
            self._send_root({"type": "CHILD_DEAD", "rank": rank,
                             "pid": pid, "node": self.node,
                             "status": status})
        except OSError:
            pass

    def _hb_loop(self):
        """Daemon-ring observer: ping the successor daemon's listener
        every period; `timeout` seconds of consecutive silence raise a
        SUSPECT_NODE to the root. This is what catches a hung *daemon* —
        from outside, a panicked node: its control channel stays open
        but nothing (worker relays, CHILD_DEADs, ring ACKs) comes out."""
        missed = 0.0
        last_succ = None
        while True:
            time.sleep(self.hb_period)
            if self._silent.is_set():
                return
            table = dict(self.daemon_table)
            ring = sorted(table)
            if len(ring) < 2 or self.node not in ring:
                continue
            succ = ring[(ring.index(self.node) + 1) % len(ring)]
            if succ != last_succ:
                # ring moved (recovery, grow, spare admission): misses
                # accumulated against the old successor must not count
                # against the new one
                missed = 0.0
                last_succ = succ
            ok = False
            try:
                s = connect("127.0.0.1", table[succ],
                            timeout=self.hb_period)
                s.settimeout(max(self.hb_period, 0.05))
                send_msg(s, {"type": "DAEMON_HB_PING", "from": self.node})
                ok = recv_msg(s) is not None
                s.close()
            except OSError:
                ok = False
            if ok:
                missed = 0.0
                continue
            if succ not in self.daemon_table:
                missed = 0.0        # table moved: stale observation
                continue
            missed += self.hb_period
            if missed >= self.hb_timeout:
                try:
                    self._send_root({"type": "SUSPECT_NODE", "node": succ,
                                     "by": self.node})
                except OSError:
                    pass
                missed = 0.0

    def _worker_accept_loop(self):
        while True:
            try:
                conn, _ = self.wsock.accept()
            except OSError:
                return
            threading.Thread(target=self._worker_conn, args=(conn,),
                             daemon=True).start()

    def _worker_conn(self, conn):
        rank = None
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                if self._silent.is_set():
                    return          # hung daemon: answers nothing, to anyone
                t = msg["type"]
                if t == "DAEMON_HB_PING":
                    # a neighbour daemon's ring observation
                    send_msg(conn, {"type": "HB_ACK", "node": self.node})
                elif t == "HANG_NODE":
                    self._hang_node()
                elif t == "REGISTER_WORKER":
                    rank = msg["rank"]
                    with self.lock:
                        self.worker_socks[rank] = conn
                        table = self.last_table
                    self._send_root({**msg, "node": self.node})
                    # replay the newest rank table to the late joiner so a
                    # re-spawned rank starts its buddy pull immediately —
                    # overlapping the restore with the rest of the
                    # world's re-registration (survivor entries in the
                    # cached table stay valid; a stale entry for another
                    # re-spawned rank just refuses the connect and the
                    # puller falls back to its file checkpoint)
                    if table is not None:
                        try:
                            with self.send_lock:
                                send_msg(conn, table)
                        except OSError:
                            pass
                elif t == "KILL_NODE":
                    self._die_hard()
                elif t == "BREAK_CHANNEL":
                    # network-partition emulation: sever the root channel
                    # only. The root sees an EOF (node failure), and the
                    # shutdown wakes our own run loop blocked in recv —
                    # the partitioned node then fences itself (children
                    # first), exactly fail-stop semantics.
                    try:
                        self.root_sock.shutdown(socket.SHUT_RDWR)
                        self.root_sock.close()
                    except OSError:
                        pass
                else:      # BARRIER / DONE — relay up
                    self._send_root(msg)
        except OSError:
            return

    def _kill_children_silently(self):
        """SIGKILL every child with the monitor stopped first, so their
        deaths are never relayed — the way a dead or hung node looks."""
        self.monitor._stop.set()
        with self.lock:
            procs = list(self.workers.values())
        for p in procs:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def _die_hard(self):
        """Node-failure emulation: children first, then ourselves — a
        real dead node sends nothing."""
        self._kill_children_silently()
        os.kill(os.getpid(), signal.SIGKILL)

    def _hang_node(self):
        """Node-hang emulation: the node panics — its processes stop
        responding but nothing exits, so every channel stays open and no
        SIGCHLD/EOF fires anywhere. Children are SIGKILLed silently and
        the daemon goes mute; only the daemon-ring heartbeat sees it."""
        self._kill_children_silently()
        self._silent.set()

    # --------------------------------------------------------------- root

    def _broadcast_workers(self, msg: dict):
        with self.lock:
            socks = dict(self.worker_socks)
        for rank, s in socks.items():
            try:
                with self.send_lock:
                    send_msg(s, msg)
            except OSError:
                pass

    def _spawn_many(self, ranks, *, restarted: bool, epoch: int,
                    shadow: bool = False):
        """fork+exec the ranks concurrently — the spawn fan-out inside a
        node happens in parallel, so a node-failure respawn costs one
        spawn latency, not len(ranks) of them."""
        if len(ranks) <= 1:
            for r in ranks:
                self.spawn_worker(r, restarted=restarted, epoch=epoch,
                                  shadow=shadow)
            return
        threads = [threading.Thread(target=self.spawn_worker, args=(r,),
                                    kwargs={"restarted": restarted,
                                            "epoch": epoch,
                                            "shadow": shadow})
                   for r in ranks]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    def run(self):
        while True:
            sock = self.root_sock
            try:
                msg = recv_msg(sock)
            except OSError:           # channel broken (possibly injected)
                msg = None
            if self._silent.is_set():
                threading.Event().wait()     # hung node: mute forever
            if msg is None:
                if self.root_sock is not sock:
                    continue          # relay thread already re-homed us
                if self._rehome(sock):
                    continue          # primary died: now homed on standby
                self._die_hard()      # root gone: tear everything down
            t = msg["type"]
            if t == "SPAWN":          # initial deployment or Algorithm 2
                self._spawn_many(msg["ranks"], restarted=msg["restarted"],
                                 epoch=msg["epoch"],
                                 shadow=msg.get("shadow", False))
            elif t in ("REINIT", "GROW"):
                # Algorithm 2: signal survivors, spawn assigned ranks.
                # GROW is the same daemon-side motion over an *expanding*
                # world: the rejoined daemon spawns the re-admitted ranks
                # (restarted=True: they restore from their last durable
                # checkpoints), survivors roll back to the pinned cut —
                # plus the membership relay so control loops adopt the
                # re-expanded world and mesh epoch
                mine = [r for d, r in msg["respawns"] if d == self.node]
                with self.lock:
                    pids = [p.pid for r, p in self.workers.items()
                            if r not in mine and p.poll() is None]
                for pid in pids:
                    try:
                        os.kill(pid, signal.SIGUSR1)
                    except ProcessLookupError:
                        pass
                for r in mine:
                    self.monitor.unwatch(r)
                if t == "GROW":
                    self._broadcast_workers(msg)
                self._spawn_many(mine, restarted=True, epoch=msg["epoch"])
                self._send_root({"type": "REINIT_DONE",
                                 "node": self.node,
                                 "epoch": msg["epoch"]})
            elif t == "SHRINK":
                # shrinking recovery: no spawns anywhere — signal every
                # live child to roll back, then relay the shrunk world so
                # their control loops pick up the new membership/epoch
                with self.lock:
                    pids = [p.pid for p in self.workers.values()
                            if p.poll() is None]
                for pid in pids:
                    try:
                        os.kill(pid, signal.SIGUSR1)
                    except ProcessLookupError:
                        pass
                self._broadcast_workers(msg)
            elif t == "PROMOTE":
                # replica failover: hand the promote order to the named
                # shadow only — it composes its warm frame and enters
                # the BSP loop at the resume step
                with self.lock:
                    s = self.worker_socks.get(msg["rank"])
                if s is not None:
                    try:
                        with self.send_lock:
                            send_msg(s, msg)
                    except OSError:
                        pass
            elif t == "KILL_RANK":
                # root-side stall watchdog: a silent (hung) child cannot
                # be detected by waitpid — the root orders the kill and
                # the ensuing SIGCHLD drives the normal failure path
                with self.lock:
                    p = self.workers.get(msg["rank"])
                if p is not None:
                    try:
                        os.kill(p.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
            elif t == "KILL_NODE":
                # root-ordered node drain (gray-failure mitigation): a
                # persistently degraded node is taken down whole — the
                # channel EOF then drives the normal node-failure path
                self._die_hard()
            elif t == "DAEMON_TABLE":
                # ring membership for the daemon-level heartbeat; not
                # relayed to workers (node-level concern only)
                self.daemon_table = dict(msg["table"])
            elif t in ("RANK_TABLE", "BARRIER_RELEASE", "JOIN_RELEASE",
                       "FENCE_RELEASE", "RESYNC", "SHUTDOWN"):
                if t == "RANK_TABLE":
                    with self.lock:
                        self.last_table = msg
                self._broadcast_workers(msg)
                if t == "SHUTDOWN":
                    # join on the children's exits (they os._exit on the
                    # relayed SHUTDOWN) rather than sleeping a fixed drain
                    with self.lock:
                        procs = list(self.workers.values())
                    for p in procs:
                        try:
                            p.wait(timeout=2)
                        except subprocess.TimeoutExpired:
                            p.terminate()
                            try:
                                p.wait(timeout=1)
                            except subprocess.TimeoutExpired:
                                p.kill()
                    os._exit(0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--node", required=True)
    ap.add_argument("--root-port", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--fail-step", type=int, default=-1)
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--fail-kind", default="process")
    ap.add_argument("--scenario", default="")
    ap.add_argument("--hb-period", type=float, default=0.0)
    ap.add_argument("--hb-timeout", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--pythonpath", default="")
    ap.add_argument("--standby-port", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the workers' state")
    Daemon(ap.parse_args(argv)).run()


if __name__ == "__main__":
    main()
