"""Host spans and counts around the calls into the program's layers,
taken from the benchmark's own wrappers in a traced run (the program
records none of its own yet).

Each wrapper replaces a method of the program's class for the run and
puts it back after. A span is (name, start, end, info) on the monotonic
clock. The model step's wrappers synchronise the card before the span
ends, so a span holds the device work it launched (the engine reads its
result on the host right after the call in any case).
"""
from __future__ import annotations

import contextlib
import threading
import time


class Spans:
    def __init__(self):
        self.spans: list = []                # (name, t0, t1, info)
        self._engine = threading.local()

    def add(self, name: str, t0: float, t1: float, **info):
        self.spans.append((name, t0, t1, info))

    @contextlib.contextmanager
    def installed(self, torch):
        """Wrap the engine's step, admission's prefill, the decode step,
        the replicator's publish and compose, a restore and a recovery."""
        from repro_torch.models.model import Model
        from repro_torch.serve.cluster import ServeCluster
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.replicate import ServeReplicator
        sync = torch.cuda.synchronize if torch.cuda.is_available() \
            else (lambda: None)
        me = self
        saved = [(ServeEngine, "step", ServeEngine.step),
                 (ServeEngine, "restore", ServeEngine.restore),
                 (Model, "prefill", Model.prefill),
                 (Model, "decode_step", Model.decode_step),
                 (ServeReplicator, "publish", ServeReplicator.publish),
                 (ServeReplicator, "compose",
                  ServeReplicator.__dict__["compose"]),
                 (ServeCluster, "_recover", ServeCluster._recover)]
        step, restore = ServeEngine.step, ServeEngine.restore
        prefill, decode = Model.prefill, Model.decode_step
        publish = ServeReplicator.publish
        compose = ServeReplicator.compose
        recover = ServeCluster._recover

        def w_step(eng):
            me._engine.current = eng
            t0 = time.monotonic()
            try:
                return step(eng)
            finally:
                me.add("engine.step", t0, time.monotonic(), engine=eng.name)

        def w_prefill(model, params, batch, max_len):
            toks = batch["tokens"]
            t0 = time.monotonic()
            out = prefill(model, params, batch, max_len)
            sync()
            t1 = time.monotonic()
            # lanes that are not copies of lane 0 (the padding of a call)
            lanes = 1 + int((toks[1:] != toks[:1]).any(-1).sum()) \
                if toks.shape[0] > 1 else 1
            eng = getattr(me._engine, "current", None)
            me.add("model.prefill", t0, t1, lanes=lanes, S=int(toks.shape[1]),
                   engine=eng.name if eng is not None else None)
            return out

        def w_decode(model, params, token, state, pos):
            eng = getattr(me._engine, "current", None)
            active = [] if eng is None else [
                int(eng.pos[i]) for i, s in enumerate(eng.slots)
                if s is not None]
            t0 = time.monotonic()
            out = decode(model, params, token, state, pos)
            sync()
            me.add("model.decode_step", t0, time.monotonic(),
                   positions=active,
                   engine=eng.name if eng is not None else None)
            return out

        def w_publish(rep, engine):
            before = rep.bytes_published
            t0 = time.monotonic()
            out = publish(rep, engine)
            me.add("replicator.publish", t0, time.monotonic(),
                   nbytes=rep.bytes_published - before, kind=rep.last_kind,
                   engine=engine.name)
            return out

        def w_compose(frames, step=None):
            t0 = time.monotonic()
            try:
                return compose(frames, step)
            finally:
                me.add("replicator.compose", t0, time.monotonic())

        def w_restore(eng, snap):
            t0 = time.monotonic()
            out = restore(eng, snap)
            sync()
            me.add("engine.restore", t0, time.monotonic(), engine=eng.name)
            return out

        def w_recover(cluster, rank, rnd):
            t0 = time.monotonic()
            try:
                return recover(cluster, rank, rnd)
            finally:
                me.add("cluster.recover", t0, time.monotonic(), rank=rank)

        ServeEngine.step, ServeEngine.restore = w_step, w_restore
        Model.prefill, Model.decode_step = w_prefill, w_decode
        ServeReplicator.publish = w_publish
        ServeReplicator.compose = staticmethod(w_compose)
        ServeCluster._recover = w_recover
        try:
            yield self
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)


def patched(module, name: str, wrap):
    """Context manager: `module.name` replaced by `wrap(original)`."""
    @contextlib.contextmanager
    def cm():
        orig = getattr(module, name)
        setattr(module, name, wrap(orig))
        try:
            yield
        finally:
            setattr(module, name, orig)
    return cm()
