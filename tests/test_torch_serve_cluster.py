"""Fault-tolerant serving of the port: the serving scenario cells, delta
replication across both packages, the buddy store and the catalog.

The invariants every cell asserts (as `tests/test_serve_cluster.py` does
for the JAX package): zero requests dropped; zero duplicate and zero lost
tokens (the TokenSink ledger raises on either); transcripts bit-identical
to the fault-free run of the same load.
"""
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import serde as ref_serde
from repro.checkpoint.memory_ckpt import BuddyStore as RefBuddyStore
from repro.scenarios import catalog as ref_catalog
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.replicate import ServeReplicator as RefServeReplicator
from repro_torch.checkpoint import serde
from repro_torch.checkpoint.memory_ckpt import (BuddyStore, buddy_exchange,
                                                restore_from_buddy)
from repro_torch.scenarios import catalog
from repro_torch.scenarios.catalog import SERVE_CATALOG
from repro_torch.serve import (LoadGen, Request, ServeCluster, ServeEngine,
                               ServeReplicator)
from _torch_serve_model import serve_models
from _torch_threads import few_threads  # noqa: F401  (autouse)

FAST_CELLS = [s for s in SERVE_CATALOG if "fast" in s.tags]


@pytest.fixture(scope="module")
def setup():
    _, port, _, tp = serve_models(compute_dtype="bfloat16")
    return port, tp


def _load_for(sc):
    return LoadGen(world=sc.world, rounds=sc.rounds,
                   per_round=sc.per_round, max_new=sc.max_new_tokens,
                   seed=sc.seed)


_REF_CACHE: dict = {}


def _reference(model, params, sc):
    """Fault-free transcripts for the cell's load (cells sharing a load
    share the reference)."""
    key = (sc.world, sc.n_slots, sc.max_len, sc.rounds, sc.per_round,
           sc.max_new_tokens, sc.seed)
    if key not in _REF_CACHE:
        c = ServeCluster(model, params, world=sc.world,
                         n_slots=sc.n_slots, max_len=sc.max_len)
        m = c.run(_load_for(sc), rounds=sc.rounds)
        assert m["requests_dropped"] == 0
        _REF_CACHE[key] = c.transcripts()
    return _REF_CACHE[key]


def _run_cell(model, params, sc):
    c = ServeCluster(model, params, world=sc.world, n_slots=sc.n_slots,
                     max_len=sc.max_len, strategy=sc.strategy,
                     publish_every=sc.publish_every,
                     respawn_delay=sc.respawn_delay)
    m = c.run(_load_for(sc), rounds=sc.rounds, fault=sc.fault())
    return c, m


@pytest.mark.parametrize("sc", FAST_CELLS, ids=lambda s: s.name)
def test_serve_cell_recovers_lossless(setup, sc):
    model, params = setup
    ref = _reference(model, params, sc)
    c, m = _run_cell(model, params, sc)
    assert m["kills"], "the fault never fired"
    assert m["requests_dropped"] == 0, m["dropped_rids"]
    assert sc.expect_bit_identical
    got = c.transcripts()
    assert {rid for rid in ref if got.get(rid) != ref[rid]} == set()
    assert m["kills"][0]["tokens_to_first_recovered_token"] is not None


def test_replica_promotes_faster_than_reinit(setup):
    """A warm standby's first recovered token arrives after strictly
    fewer foreign tokens than a reinit respawn's."""
    model, params = setup
    by_name = {s.name: s for s in SERVE_CATALOG}
    ttfrt = {}
    for name in ("serve-rank-loss", "serve-replica-promote"):
        sc = by_name[name]
        _, m = _run_cell(model, params, sc)
        assert m["requests_dropped"] == 0
        ttfrt[sc.strategy] = m["kills"][0]["tokens_to_first_recovered_token"]
    assert ttfrt["replica"] < ttfrt["reinit"], ttfrt


# ----------------------------------------------------------- replication


class _Recorder:
    def __init__(self):
        self.frames: dict = {}

    def save(self, step, payload):
        self.frames[step] = payload


def test_replicator_delta_frames_cost_o_dirt(setup):
    """Between publishes, a decode step dirties one KV position per layer
    per active slot: the delta frame is a small fraction of the full."""
    model, params = setup
    eng = ServeEngine(model, params, n_slots=4, max_len=128)
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=[4, 5, 6], max_new_tokens=40))
    rec = _Recorder()
    rep = ServeReplicator(rec, base_every=8)
    eng.step()
    rep.publish(eng)
    assert rep.last_kind == "full"
    base_size = len(rec.frames[0])
    for _ in range(3):
        eng.step(); eng.step()
        rep.publish(eng)
        assert rep.last_kind == "delta"
    delta_sizes = [len(rec.frames[s]) for s in (1, 2, 3)]
    assert max(delta_sizes) < base_size / 4, (delta_sizes, base_size)


def test_replicator_compose_restores_exact_engine(setup):
    """publish -> compose -> restore lands an engine that decodes
    bit-identically to the original continuing uninterrupted."""
    model, params = setup
    eng = ServeEngine(model, params, n_slots=2, max_len=64)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=[8, 9, rid], max_new_tokens=6))
    rec = _Recorder()
    rep = ServeReplicator(rec, base_every=4)
    for _ in range(4):
        eng.step()
        rep.publish(eng)
    expected = {r.rid: list(r.out) for r in eng.run_until_drained()}

    eng2 = ServeEngine(model, params, n_slots=2, max_len=64)
    eng2.restore(ServeReplicator.compose(rec.frames))
    got = {r.rid: list(r.out) for r in eng2.run_until_drained()}
    assert got == {k: expected[k] for k in got}
    assert sorted(got) == sorted(expected)


def _leaf_bits(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy().tobytes()
    return np.asarray(v).tobytes()


def _same_snapshot(a, b):
    for key in ("pos", "slots", "queue", "tick"):
        assert np.array_equal(np.asarray(a[key], dtype=object),
                              np.asarray(b[key], dtype=object)), key
    assert sorted(a["state"]) == sorted(b["state"]) == ["k", "v"]
    for k in ("k", "v"):
        assert _leaf_bits(a["state"][k]) == _leaf_bits(b["state"][k]), k


def _drive(eng, req_cls, rec, rep, peek_kind):
    """Four published steps of a 3-request load on a 2-slot engine: a
    full frame, then a delta chain."""
    for rid in range(3):
        eng.submit(req_cls(rid=rid, prompt=[8, 9, rid + 1],
                           max_new_tokens=5))
    for _ in range(4):
        eng.step()
        rep.publish(eng)
    assert [peek_kind(rec.frames[s]) for s in range(4)] == \
        ["full", "delta", "delta", "delta"]


def test_port_frames_compose_under_reference():
    """A frame chain published by the port's replicator composes under
    the reference's `ServeReplicator.compose` into the same snapshot."""
    _, port, _, tp = serve_models(compute_dtype="bfloat16")
    rec = _Recorder()
    _drive(ServeEngine(port, tp, n_slots=2, max_len=256), Request, rec,
           ServeReplicator(rec, base_every=4), ref_serde.peek_kind)
    _same_snapshot(ServeReplicator.compose(rec.frames),
                   RefServeReplicator.compose(rec.frames))


def test_reference_frames_compose_under_port():
    """A frame chain published by the JAX engine composes under the
    port's `compose`, and the port's engine restores from it."""
    ref, port, rp, tp = serve_models(compute_dtype="bfloat16")
    rec = _Recorder()
    _drive(RefServeEngine(ref, rp, n_slots=2, max_len=256), RefRequest,
           rec, RefServeReplicator(rec, base_every=4), serde.peek_kind)
    snap = ServeReplicator.compose(rec.frames)
    _same_snapshot(snap, RefServeReplicator.compose(rec.frames))
    eng = ServeEngine(port, tp, n_slots=2, max_len=256)
    eng.restore(snap)
    for k in ("k", "v"):
        assert _leaf_bits(eng.state[k]) == _leaf_bits(snap["state"][k])
    assert len(eng.run_until_drained()) == 3


# ------------------------------------------------------------ buddy store


def _chain_frames():
    """Five frames of one leaf: a full frame, then one-tile deltas."""
    cur = {"x": np.arange(3000, dtype=np.float32)}
    frames = [serde.to_bytes(cur, {"step": 1})]
    tiles = serde.tile_digests(cur)
    for step in range(2, 6):
        cur = {"x": np.array(cur["x"])}
        cur["x"][step] += 1.0
        plan = serde.delta_plan(cur, tiles)
        frames.append(serde.to_delta_bytes(cur, plan, base_step=step - 1,
                                           extra={"step": step}))
        tiles = plan.new_tiles
    return frames


@pytest.mark.parametrize("case", ["raw-local", "raw-held", "delta-chain"])
def test_buddy_store_matches_reference(tmp_path, case):
    """The same saves and holds leave both packages' stores with the same
    maps, counters and spill files."""
    if case == "delta-chain":
        ops = [("save", i + 1, f) for i, f in enumerate(_chain_frames())]
    elif case == "raw-local":
        ops = [("save", s, bytes([s]) * 256) for s in range(1, 8)]
    else:
        ops = [("hold", s, bytes([s]) * 64) for s in (1, 2, 9, 10)]
    stores = []
    for cls, sub in ((BuddyStore, "port"), (RefBuddyStore, "ref")):
        d = tmp_path / sub
        pushed = []
        s = cls(0, 4, lambda *a, pushed=pushed: pushed.append(a), retain=1,
                spill_dir=str(d), hot_steps=1)
        for op, step, payload in ops:
            if op == "save":
                s.save(step, payload)
            else:
                s.hold(1, step, payload)
        files = sorted(os.listdir(d)) if d.exists() else []
        stores.append((s.local_map(), s.held_map(1), s.spilled_bytes,
                       s.resident_bytes(), files, pushed))
    assert stores[0] == stores[1]


def test_mesh_buddy_exchange_is_not_ported():
    """The buddy exchange is ported (its 4-rank ring is in
    test_torch_sharding.py): on a world-1 CPU mesh both directions return
    the state unchanged, as the reference's do on an axis of one."""
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.sharding.rules import PRESETS
    state = {"embedding": {"table": torch.arange(12.0).reshape(4, 3)},
             "step": torch.zeros((), dtype=torch.int32)}
    with process_group(device="cpu"):
        mesh = make_host_mesh((1,), ("data",), device="cpu")
        for fn in (buddy_exchange, restore_from_buddy):
            assert fn(state, mesh, PRESETS["pod"]) is state


def test_catalog_is_the_reference_catalog():
    for name in ("CATALOG", "SERVE_CATALOG"):
        ours = [s.to_dict() for s in getattr(catalog, name)]
        theirs = [s.to_dict() for s in getattr(ref_catalog, name)]
        assert ours == theirs
    assert catalog.get_serve_scenario("serve-mid-prefill").to_dict() == \
        ref_catalog.get_serve_scenario("serve-mid-prefill").to_dict()
    with pytest.raises(KeyError):
        catalog.get_scenario("no-such-cell")
