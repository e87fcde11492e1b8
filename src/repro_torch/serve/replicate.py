"""Delta-frame replication of a serving engine's churning state (the
PyTorch port of the JAX package's replicator; frames are byte-identical
across the two packages).

Params are immutable, so the only state a serving rank can lose is the
churn: the decode KV/SSM caches, the slot table (which request sits
where, how far it has decoded, what was already emitted) and the pending
queue. `ServeReplicator` turns an engine snapshot into a serde frame —
a tile-range *delta* against the previous frame whenever the chain
allows it — and pushes it into a BuddyStore, exactly the fabric the
training workers replicate through. One decode step dirties one KV
position per layer per active slot, so the per-step frame costs O(dirt),
not O(state); the `FramePublisher` cadence inserts full-frame anchors so
a chain is always composable from the retention window.

The subscribe side is symmetric: `compose()` folds the held frames back
into an engine snapshot that `ServeEngine.restore()` accepts. Both
recovery strategies ride this stream:

* reinit  — a respawned rank composes its buddy's held frames once,
            restores, and replays (emission-suppressed) to the fault
            point;
* replica — a warm standby applies *every* frame as it is published, so
            promotion is a pointer swap with nothing to compose.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint import serde
from repro_torch.checkpoint.manifest import flatten_state, unflatten_state

from .engine import host_state


class ServeReplicator:
    """Publish side of one serving rank's state stream.

    `store` is anything with `save(step, payload)` — in production the
    rank's BuddyStore (which pushes a copy to its ring buddy), in tests a
    plain recorder. Snapshot meta (slot table, queue, positions, tick)
    rides in the frame's JSON header; only the decode state contributes
    bulk bytes.
    """

    def __init__(self, store, *, base_every: int = 4,
                 max_dirty: float = 0.5, start_step: int = 0):
        self.store = store
        self._pub = serde.FramePublisher(base_every, max_dirty,
                                         contiguous=True)
        # `start_step` lets a respawned incarnation continue the step
        # numbering past its predecessor's chain, so the buddy's stale
        # held frames age out of the retention window instead of
        # shadowing the new chain as "newest composable"
        self.next_step = start_step
        self.bytes_published = 0
        self.last_kind: Optional[str] = None

    def publish(self, engine) -> int:
        """Snapshot `engine` and push one frame; returns the frame step.
        Frame steps are a contiguous counter (0, 1, 2, ...) independent
        of the engine tick — the BuddyStore retention walk and the
        `contiguous` chain policy assume step-1 parents, and the engine
        tick advances by the publish cadence, not by 1. The tick rides in
        the frame meta instead. The snapshot's async D2H drain overlaps
        the flatten; `host_state` waits for each leaf's copy."""
        step = self.next_step
        self.next_step += 1
        with tracing.span("replicate.publish", engine=engine.name,
                          step=step) as sp:
            with tracing.span("replicate.snapshot"):
                snap = engine.snapshot()
            with tracing.span("replicate.d2h_wait"):
                state = host_state(snap["state"])
            with tracing.span("replicate.flatten"):
                flat = flatten_state(state)
            meta = {"pos": [int(p) for p in snap["pos"]],
                    "slots": snap["slots"], "queue": snap["queue"],
                    "tick": int(snap["tick"])}
            payload = self._pub.publish(flat, step, extra={"serve": meta})
            with tracing.span("replicate.push"):
                self.store.save(step, payload)
            self.bytes_published += len(payload)
            self.last_kind = self._pub.last_kind
            sp.set(kind=self.last_kind, bytes=len(payload))
        return step

    def rebase(self):
        """Force the next frame full — the buddy holding this stream's
        history died, so a delta would chain to frames nobody holds."""
        self._pub.rebase()

    @staticmethod
    def compose(frames: Dict[int, bytes], step: Optional[int] = None
                ) -> Dict[str, Any]:
        """Fold a frame map (e.g. `BuddyStore.held_map(origin)`) into an
        engine snapshot at `step` (default: newest composable step).
        Raises KeyError if no composable step exists."""
        if step is None:
            steps = serde.composable_steps(frames)
            if not steps:
                raise KeyError("no composable step in frame map")
            step = steps[-1]
        extra, flat = serde.compose(frames, step)
        meta = extra["serve"]
        # writable copies of the frame's leaves (bfloat16 leaves are
        # already CPU tensors of their own)
        return {
            "state": unflatten_state(
                {k: v if isinstance(v, torch.Tensor) else np.array(v)
                 for k, v in flat.items()}),
            "pos": np.asarray(meta["pos"], np.int32),
            "slots": meta["slots"],
            "queue": meta["queue"],
            "tick": int(meta["tick"]),
        }
