"""One engine's state published two ways after each step: by
`ServeReplicator`, which digests the snapshot's clones where they live,
and by a `FramePublisher` fed the host copy, which digests it in numpy,
as the runtime worker's publisher is fed host leaves. The serving tests
hold the two to the same frames, kinds and tile digests."""
import types

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint import serde
from repro_torch.checkpoint.manifest import flatten_state
from repro_torch.kernels.checksum.ops import byte_stream
from repro_torch.kernels.checksum.ref import tile_checksums_ref
from repro_torch.serve import ServeReplicator
from repro_torch.serve.engine import host_state


class Recorder:
    """A store that keeps every frame saved into it."""

    def __init__(self):
        self.frames: dict = {}

    def save(self, step, payload):
        self.frames[step] = payload


def ref_rows(v) -> np.ndarray:
    """The numpy reference's tile digests of a host leaf (a bfloat16 leaf
    is a CPU tensor: its bytes)."""
    if isinstance(v, torch.Tensor):
        v = byte_stream(v).numpy()
    return tile_checksums_ref(v)


def publish_both(eng, steps: int, base_every: int = 3):
    """Step `eng` `steps` times, publishing after each step both ways.
    Returns frames, kinds and each step's tiles of the replicator (`rep_*`)
    and of the host publisher (`host_*`), each side's tracer counters, and
    each step's host flat state."""
    rec = Recorder()
    rep = ServeReplicator(rec, base_every=base_every)
    pub = serde.FramePublisher(base_every, contiguous=True)
    on_rep, on_host = tracing.Tracer(), tracing.Tracer()
    out = types.SimpleNamespace(rep_kinds=[], host_kinds=[], host_frames=[],
                                rep_tiles=[], host_tiles=[], flats=[])
    for step in range(steps):
        eng.step()
        with tracing.recording(on_rep):
            assert rep.publish(eng) == step
        snap = eng.snapshot()
        flat = flatten_state(host_state(snap["state"]))
        meta = {"pos": [int(p) for p in snap["pos"]],
                "slots": snap["slots"], "queue": snap["queue"],
                "tick": int(snap["tick"])}
        with tracing.recording(on_host):
            out.host_frames.append(pub.publish(flat, step,
                                               extra={"serve": meta}))
        out.rep_kinds.append(rep.last_kind)
        out.host_kinds.append(pub.last_kind)
        out.rep_tiles.append(rep._pub.chain.prev[1])
        out.host_tiles.append(pub.chain.prev[1])
        out.flats.append(flat)
    out.rep_frames = [rec.frames[s] for s in range(steps)]
    out.rep_counters, out.host_counters = on_rep.counters, on_host.counters
    return out


def assert_same_publishes(out):
    """The replicator's frames, kinds and tiles are the host path's."""
    assert out.rep_kinds == out.host_kinds
    assert out.rep_frames == out.host_frames
    for rep, host in zip(out.rep_tiles, out.host_tiles):
        assert rep.keys() == host.keys()
        for k in host:
            assert rep[k][:3] == host[k][:3], k      # nbytes, dtype, shape
            assert rep[k].rows.dtype == np.uint32
            assert np.array_equal(rep[k].rows, host[k].rows), k
    state_bytes = sum(t.nbytes for t in out.host_tiles[0].values())
    n = state_bytes * len(out.rep_frames)
    assert out.rep_counters["replicate.bytes_digested"] == n
    assert out.host_counters["replicate.bytes_digested"] == n
    assert out.host_counters.get("replicate.bytes_digested_device", 0) == 0
