"""Spans, counters and instants of the port's serving path, kept in memory.

Nothing is recorded until a caller makes a `Tracer` active for the
process with `recording(tracer)`; there is no environment variable, flag
or configuration key. With no tracer active, `span()` returns one shared
no-op context manager and `count`, `event`, `begin` and `end` return at
once, so the calls can sit on the serving path.

The clock is `time.monotonic_ns()`, the clock a benchmark maps the
device trace's timestamps to, so a program span lines up with the work
the card did under it. Nothing here synchronises the card, reads a
device value or writes a file.

    tracer = Tracer()
    with recording(tracer):
        cluster.run(load, rounds=...)
    tracer.spans      # [(name, t0_ns, t1_ns, parent, attrs)]
    tracer.counters   # {name: int}

`parent` is the index in `spans` of the span that was open around it on
the same thread (None at the top, and for a span opened by `begin` and
closed by `end`, which may lie on different calls). An entry is None
while its span is open. `count(name, n)` adds to the counter and to the
attrs of the innermost open span, so a span carries the counts of its
own work. An instant (`event`) is a span of no length.

`SPANS` and `COUNTERS` name everything the program records, each with
its meaning; the tests hold the code to them.
"""
from __future__ import annotations

import contextlib
import threading
import time

SPANS = (
    ("cluster.round", "one round of ServeCluster.run: arrivals, respawns, "
     "each live rank's step and publish; attr round"),
    ("cluster.kill", "instant: a rank died (ServeCluster._on_kill); "
     "attrs rank, round"),
    ("recover.compose", "a respawned rank composes its buddy's held frames "
     "(ServeReplicator.compose); attrs rank, frames and bytes held"),
    ("recover.restore", "the respawned engine restores the composed "
     "snapshot (ServeEngine.restore); attr rank"),
    ("recover.replay", "restore's end until every restored request has "
     "re-decoded up to its emission watermark; attrs rank, tokens"),
    ("request.queued", "ServeEngine.submit, or the restore that puts a "
     "request back in the queue (restored=True), until the admission that "
     "takes it; attrs rid, engine"),
    ("engine.admit", "ServeEngine._admit: queued requests prefilled into "
     "free slots"),
    ("engine.prefill", "one prefill call and the read of its first tokens; "
     "attrs lanes (real), pad_lanes, S"),
    ("engine.decode", "one decode step's model call and the read of its "
     "tokens; attr active (lanes)"),
    ("replicate.publish", "ServeReplicator.publish: one frame of a rank's "
     "state; attrs engine, step, kind, bytes"),
    ("replicate.snapshot", "ServeEngine.snapshot: device clones, D2H copies "
     "started"),
    ("replicate.d2h_wait", "host_state: the wait for the snapshot's D2H "
     "copies"),
    ("replicate.flatten", "flatten_state of the host snapshot"),
    ("replicate.digest", "tile_digests of the whole flattened state "
     "(FramePublisher.publish)"),
    ("replicate.plan", "ChainPlanner.decide on those digests: the delta "
     "plan"),
    ("replicate.encode", "the frame's bytes: to_bytes, or gather_host and "
     "to_delta_bytes_gathered; attr kind"),
    ("replicate.push", "store.save of the frame (the buddy's hold)"),
)

COUNTERS = (
    ("engine.prefill_tokens", "prompt tokens of the real lanes prefilled"),
    ("engine.prefill_pad_tokens", "tokens of the padding lanes prefilled"),
    ("replicate.bytes_digested", "bytes of state digested by "
     "replicate.digest"),
    ("replicate.bytes_framed", "bytes of the frames encoded (len of each "
     "payload)"),
    ("serve.tokens_replayed", "tokens the restored requests re-decoded "
     "without delivering them, counted when recover.replay closes"),
)


class Tracer:
    """The spans and counters of one recording."""

    def __init__(self):
        self.spans: list = []            # (name, t0_ns, t1_ns, parent, attrs)
        self.counters: dict = {}
        self._open: dict = {}            # (name, key) -> (t0_ns, attrs)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _reserve(self) -> int:
        with self._lock:
            self.spans.append(None)
            return len(self.spans) - 1

    def _parent(self):
        st = self._stack()
        return st[-1].idx if st else None

    def add(self, name: str, t0: int, t1: int, parent, attrs: dict):
        with self._lock:
            self.spans.append((name, t0, t1, parent, attrs))

    def count(self, name: str, n: int):
        st = self._stack()
        if st:
            a = st[-1].attrs
            a[name] = a.get(name, 0) + n
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


class _Span:
    __slots__ = ("tracer", "name", "attrs", "idx", "parent", "t0")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        self.parent = tr._parent()
        self.idx = tr._reserve()
        tr._stack().append(self)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        tr = self.tracer
        tr._stack().pop()
        tr.spans[self.idx] = (self.name, self.t0, t1, self.parent, self.attrs)
        return False

    def set(self, **attrs):
        """Attrs known only inside the span."""
        self.attrs.update(attrs)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _NoSpan()
_active: Tracer | None = None


def active() -> Tracer | None:
    return _active


@contextlib.contextmanager
def recording(tracer: Tracer):
    """Make `tracer` the process's active tracer; the previous one comes
    back after."""
    global _active
    prev, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = prev


def span(name: str, **attrs):
    """Context manager: one span around its block."""
    tr = _active
    if tr is None:
        return _NOOP
    return _Span(tr, name, attrs)


def count(name: str, n: int = 1):
    tr = _active
    if tr is not None:
        tr.count(name, int(n))


def event(name: str, **attrs):
    """An instant, under the innermost open span."""
    tr = _active
    if tr is not None:
        t = time.monotonic_ns()
        tr.add(name, t, t, tr._parent(), attrs)


def begin(name: str, key, **attrs):
    """Open a span that `end(name, key)` closes, on another call (a
    request's wait in a queue). Opening it again restarts it."""
    tr = _active
    if tr is not None:
        tr._open[(name, key)] = (time.monotonic_ns(), attrs)


def end(name: str, key, **attrs):
    """Close the span `begin(name, key)` opened; nothing if none is open."""
    tr = _active
    if tr is None:
        return
    got = tr._open.pop((name, key), None)
    if got is not None:
        t0, a = got
        a.update(attrs)
        tr.add(name, t0, time.monotonic_ns(), None, a)
