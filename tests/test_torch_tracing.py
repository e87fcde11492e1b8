"""The port's tracer (`repro_torch.tracing`) on the serving path: off by
default and free of effects, names held to `SPANS` and `COUNTERS`,
children inside their parents, and counts that agree with what the
cluster and the replicator report themselves. CPU, tiny model."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tracing
from repro_torch.checkpoint.manifest import flatten_state
from repro_torch.checkpoint.memory_ckpt import BuddyStore
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import (LoadGen, Request, ServeCluster, ServeEngine,
                               ServeReplicator)
from repro_torch.serve.engine import host_state
from _torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT = {"round": 4, "rank": 1, "point": "serve.decode.step"}

#: the span each span opens under (None: at the top, or opened by
#: `begin` and closed by `end` on another call)
PARENT = {
    "cluster.round": None, "cluster.kill": "cluster.round",
    "recover.compose": "cluster.round", "recover.restore": "cluster.round",
    "recover.replay": None, "request.queued": None,
    "engine.admit": "cluster.round", "engine.prefill": "engine.admit",
    "engine.decode": "cluster.round", "replicate.publish": "cluster.round",
    "replicate.snapshot": "replicate.publish",
    "replicate.d2h_wait": "replicate.publish",
    "replicate.flatten": "replicate.publish",
    "replicate.digest": "replicate.publish",
    "replicate.plan": "replicate.publish",
    "replicate.encode": "replicate.publish",
    "replicate.push": "replicate.publish",
}


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("qwen2-7b")).replace(compute_dtype="float32")
    m = Model(cfg, ExecConfig(attn_impl="pallas"))
    params = m.init(torch.Generator().manual_seed(0))
    params["embedding"]["table"] = params["embedding"]["table"] * 0.05
    return m, params


def _run(model, monkeypatch, tracer=None):
    """A cluster run through a kill of rank 1: (cluster, metrics, every
    frame saved as (rank, step, payload))."""
    m, params = model
    frames = []
    save = BuddyStore.save

    def recorded(store, step, payload):
        frames.append((store.rank, step, bytes(payload)))
        return save(store, step, payload)

    monkeypatch.setattr(BuddyStore, "save", recorded)
    c = ServeCluster(m, params, world=2, n_slots=4, max_len=64,
                     publish_every=2, respawn_delay=2)
    load = LoadGen(world=2, rounds=8, per_round=2, max_new=5, seed=0)
    if tracer is None:
        metrics = c.run(load, rounds=8, fault=dict(FAULT))
    else:
        with tracing.recording(tracer):
            metrics = c.run(load, rounds=8, fault=dict(FAULT))
    monkeypatch.setattr(BuddyStore, "save", save)
    return c, metrics, frames


@pytest.fixture(scope="module")
def runs(model):
    mp = pytest.MonkeyPatch()
    try:
        # with no tracer active, nothing may reach a tracer's records
        idle = []
        for fn in ("add", "count", "_reserve", "_parent"):
            mp.setattr(tracing.Tracer, fn,
                       lambda *a, _fn=fn, **k: idle.append(_fn))
        off = _run(model, mp)
        mp.undo()
        tracer = tracing.Tracer()
        on = _run(model, mp, tracer)
    finally:
        mp.undo()
    return off, on, tracer, idle


def _by_name(tracer, name):
    return [s for s in tracer.spans if s[0] == name]


def test_off_records_nothing(runs):
    _, _, _, idle = runs
    assert tracing.active() is None
    assert idle == []
    assert tracing.span("engine.decode") is tracing.span("cluster.round")
    tr = tracing.Tracer()
    with tracing.recording(tr):
        with tracing.span("engine.admit"):
            tracing.count("engine.prefill_tokens", 3)
    assert tracing.active() is None
    tracing.count("replicate.bytes_framed", 5)
    tracing.event("cluster.kill", rank=0)
    tracing.begin("request.queued", 1)
    tracing.end("request.queued", 1)
    with tracing.span("engine.decode"):
        pass
    assert len(tr.spans) == 1 and tr.counters == {
        "engine.prefill_tokens": 3}
    assert tr.spans[0][4] == {"engine.prefill_tokens": 3}


def test_tracing_changes_no_output(runs):
    (c_off, m_off, f_off), (c_on, m_on, f_on), _, _ = runs
    assert m_off["kills"] and m_on["kills"]
    assert m_on["requests_dropped"] == 0
    assert c_on.transcripts() == c_off.transcripts()
    assert f_on == f_off


def test_names_are_the_declared_ones(runs):
    _, _, tracer, _ = runs
    spans = {n for n, _ in tracing.SPANS}
    counters = {n for n, _ in tracing.COUNTERS}
    assert len(spans) == len(tracing.SPANS)
    assert len(counters) == len(tracing.COUNTERS)
    assert set(PARENT) == spans
    assert all(s is not None for s in tracer.spans)
    assert {s[0] for s in tracer.spans} == spans
    assert set(tracer.counters) == counters


def test_children_lie_in_their_parents(runs):
    _, _, tracer, _ = runs
    for name, t0, t1, parent, _ in tracer.spans:
        assert t0 <= t1
        if PARENT[name] is None:
            assert parent is None, name
            continue
        pname, p0, p1, _, _ = tracer.spans[parent]
        assert pname == PARENT[name], (name, pname)
        assert p0 <= t0 and t1 <= p1, name
    kills = _by_name(tracer, "cluster.kill")
    assert [(s[4]["rank"], s[4]["round"]) for s in kills] == [(1, 4)]
    assert kills[0][1] == kills[0][2]
    rounds = [s[4]["round"] for s in _by_name(tracer, "cluster.round")]
    assert rounds == list(range(len(rounds)))


def test_replicator_counts(model, runs):
    _, (c_on, _, frames), tracer, _ = runs
    assert tracer.counters["replicate.bytes_framed"] == sum(
        len(p) for _, _, p in frames)
    state_bytes = sum(v.nbytes for v in flatten_state(
        host_state(c_on.engines[0].snapshot()["state"])).values())
    pubs = _by_name(tracer, "replicate.publish")
    assert len(pubs) == len(frames)
    digests = _by_name(tracer, "replicate.digest")
    assert len(digests) == len(pubs)
    assert all(s[4]["replicate.bytes_digested"] == state_bytes
               for s in digests)
    assert tracer.counters["replicate.bytes_digested"] == \
        state_bytes * len(pubs)
    # a publish's bytes are its frame's
    enc = {s[3]: s[4] for s in _by_name(tracer, "replicate.encode")}
    for i, s in enumerate(tracer.spans):
        if s[0] == "replicate.publish":
            assert enc[i]["replicate.bytes_framed"] == s[4]["bytes"]
            assert enc[i]["kind"] == s[4]["kind"]
    assert {s[4]["kind"] for s in pubs} == {"full", "delta"}

    # one replicator: the counter grows as `bytes_published` does
    m, params = model
    eng = ServeEngine(m, params, n_slots=2, max_len=32)
    eng.submit(Request(rid=0, prompt=[3, 4, 5], max_new_tokens=6))
    rep = ServeReplicator(BuddyStore(0, 1), base_every=2)
    tr = tracing.Tracer()
    with tracing.recording(tr):
        for _ in range(3):
            eng.step()
            rep.publish(eng)
    assert tr.counters["replicate.bytes_framed"] == rep.bytes_published > 0
    assert not hasattr(rep, "frames_published")


def test_replay_counts_the_replayed_tokens(runs):
    _, (_, m_on, _), tracer, _ = runs
    kill = m_on["kills"][0]
    assert kill["replayed_tokens"] > 0
    assert tracer.counters["serve.tokens_replayed"] == kill["replayed_tokens"]
    (replay,) = _by_name(tracer, "recover.replay")
    assert replay[4] == {"rank": 1, "tokens": kill["replayed_tokens"]}
    (restore,) = _by_name(tracer, "recover.restore")
    assert restore[2] <= replay[1]
    (compose,) = _by_name(tracer, "recover.compose")
    assert compose[4]["rank"] == 1 and compose[4]["frames"] > 0
    assert compose[4]["bytes"] > 0


def test_one_queued_span_per_admission(runs):
    _, _, tracer, _ = runs
    prefills = _by_name(tracer, "engine.prefill")
    queued = _by_name(tracer, "request.queued")
    assert len(queued) == sum(s[4]["lanes"] for s in prefills)
    assert all(s[4]["engine"] in ("rank0", "rank1") for s in queued)
    pad = sum(s[4]["pad_lanes"] * s[4]["S"] for s in prefills)
    real = sum(s[4]["lanes"] * s[4]["S"] for s in prefills)
    assert tracer.counters["engine.prefill_tokens"] == real
    assert tracer.counters["engine.prefill_pad_tokens"] == pad > 0
    for s in _by_name(tracer, "engine.decode"):
        assert 1 <= s[4]["active"] <= 4


def test_tracing_module_passes_reprolint():
    baseline = os.path.join(ROOT, "reprolint-torch-baseline.json")
    with open(baseline, "rb") as f:
        before = f.read()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--strict"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 new finding(s)" in p.stdout
    with open(baseline, "rb") as f:
        assert f.read() == before


def test_tracing_module_reads_no_device_value():
    """No synchronisation, device read, file or environment in the
    tracer."""
    src = open(tracing.__file__).read()
    for word in (".cpu(", ".item(", "synchronize", ".numpy(", "open(",
                 "os.environ", "getenv", "import torch", "import os"):
        assert word not in src, word
    assert all(n.count(".") == 1 for n, _ in
               tracing.SPANS + tracing.COUNTERS)
