"""Process-global injection hook registry.

Instrumented code (FileCheckpointer's write/compose paths, the worker's
checkpoint/recovery paths) calls `fire(point, **ctx)` at its named
interruption points; when no injector is installed the call is a
two-instruction no-op, so the hooks cost nothing in production paths.

An injector is any callable `(point: str, **ctx) -> None`. The worker
installs a scenario-driven one that SIGKILLs / hangs / breaks channels;
unit tests install ad-hoc ones (e.g. the crash-atomicity test kills the
process between a shard write and the COMMITTED marker).

Thread-safety: `install`/`clear` swap a single reference; `fire` reads it
once. Injectors themselves must tolerate concurrent calls (checkpoint IO
pools fire from worker threads).
"""
from __future__ import annotations

from typing import Callable, Optional

_injector: Optional[Callable] = None


def install(injector: Callable) -> None:
    """Install `injector` as the process-global hook target."""
    global _injector
    _injector = injector


def clear() -> None:
    global _injector
    _injector = None


def active() -> Optional[Callable]:
    return _injector


def fire(point: str, **ctx) -> None:
    """Fire a named interruption point. No-op unless an injector is
    installed. Whatever the injector raises propagates — a test injector
    may abort the surrounding operation with an exception on purpose."""
    inj = _injector
    if inj is not None:
        inj(point, **ctx)
