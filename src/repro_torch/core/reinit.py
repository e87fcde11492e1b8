"""The MPI_Reinit analogue: a rollback-point API for resilient drivers.

Paper interface (C):
    int MPI_Reinit(int argc, char **argv, MPI_Restart_point fn)
Here:
    reinit_main(fn, runtime=...) -> runs fn(state) under rollback protection.

`fn` receives the RankState (NEW / REINITED / RESTARTED) exactly like the
paper's restart-point function, and is expected to load its latest
checkpoint and resume. Rollback is requested either synchronously (the
driver observes a failure and raises RollbackSignal — the "test function"
variant the paper proposes in §3.2 Discussion, which is the only sound
option inside a jitted SPMD step), or asynchronously via SIGUSR1
(SIGREINIT) in the process runtime, where the handler arms a flag and the
next safe-point check raises.
"""
from __future__ import annotations

import contextlib
import signal
import threading
from typing import Callable, Optional

from .events import RankState


class RollbackSignal(Exception):
    """Raised at a safe point to unwind to the reinit rollback point
    (the setjmp/longjmp adaptation)."""

    def __init__(self, epoch: int = 0):
        super().__init__(f"rollback to reinit point (epoch {epoch})")
        self.epoch = epoch


class _RollbackFlag:
    def __init__(self):
        self._armed = threading.Event()
        self.epoch = 0
        # True only while the main thread sits inside an interruptible()
        # region (a blocking wait that is safe to unwind). The paper's
        # masked/deferred-signal split: SIGREINIT raises *immediately*
        # inside the region — no polling period — and defers to the next
        # check() everywhere else.
        self._interruptible = False

    def arm(self, epoch: int = 0):
        self.epoch = epoch
        self._armed.set()

    def check(self):
        """Safe-point test: raises RollbackSignal if a rollback is armed."""
        if self._armed.is_set():
            self._armed.clear()
            raise RollbackSignal(self.epoch)

    def clear(self):
        self._armed.clear()

    @contextlib.contextmanager
    def interruptible(self):
        """Marks a blocking wait as a safe point: SIGREINIT delivered
        inside unwinds the wait at once (event-driven rollback, replacing
        the recovery path's polling sleeps)."""
        self._interruptible = True
        try:
            self.check()          # armed before we blocked: unwind now
            yield
        finally:
            self._interruptible = False


ROLLBACK = _RollbackFlag()

SIGREINIT = signal.SIGUSR1


def install_sigreinit(flag: _RollbackFlag = ROLLBACK):
    """Installs the SIGREINIT (SIGUSR1) handler. Python delivers signals at
    bytecode boundaries in the main thread — the handler arms the flag and
    raises immediately when the main thread is inside an
    ROLLBACK.interruptible() wait (a declared safe point), which matches
    the paper's masked-deferred-signal implementation."""

    def handler(signum, frame):
        flag.arm()
        if flag._interruptible:
            flag._armed.clear()
            raise RollbackSignal(flag.epoch)

    signal.signal(SIGREINIT, handler)


def reinit_main(fn: Callable[[RankState], int], *,
                initial_state: RankState = RankState.NEW,
                max_restarts: int = 16,
                flag: _RollbackFlag = ROLLBACK,
                on_rollback: Optional[Callable[[int], None]] = None) -> int:
    """Run `fn` under rollback protection; returns its final return value.

    Mirrors MPI_Reinit's control flow: first entry with NEW (or RESTARTED
    for re-spawned processes), subsequent entries after rollback with
    REINITED. MPI state outside the loop is the runtime's job; application
    state is the checkpoint's job (both per the paper's split).
    """
    state = initial_state
    for _ in range(max_restarts):
        try:
            flag.clear()
            return fn(state)
        except RollbackSignal as rb:
            if on_rollback is not None:
                on_rollback(rb.epoch)
            state = RankState.REINITED
    raise RuntimeError(f"exceeded {max_restarts} rollbacks")
