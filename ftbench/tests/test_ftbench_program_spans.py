"""The readers of the program's own spans and counters
(`metrics/_program.py` and its five metrics): their arithmetic on
hand-made records and device events, a traced CPU run that reads the four
that need no card, an untraced run that turns no tracer on, and the
program's span names apart from the benchmark's wrappers'."""
import re
import types

import numpy as np
import pytest

from ftbench.harness import bench, spec
from ftbench.harness.spans import Spans

NEW = ("publish_digest_share", "digest_gb_per_s", "decode_device_share",
       "admit_wait_p90_ms", "recovery_restore_s")
UNITS = {"publish_digest_share": "%", "digest_gb_per_s": "GB/s",
         "decode_device_share": "%", "admit_wait_p90_ms": "ms",
         "recovery_restore_s": "s", "publish_share": "%",
         "latency_p90_ms": "ms", "setup_s": "s"}


def _rec(program, **kw):
    """A traced run's record, its program spans added to the benchmark's
    as `_program.instrument` adds them."""
    spans = Spans()
    spans.spans.extend(program)
    r = types.SimpleNamespace(t0=100.0, t_close=110.0, seconds=10.0,
                              spans=spans, device=None, kill=None,
                              program_spans=program)
    r.__dict__.update(kw)
    return r


def _read(name, rec):
    return spec.reader(name).read(rec)


def test_digest_readers():
    b = "replicate.bytes_digested"
    rec = _rec([("replicate.digest", 99.5, 100.5, {b: 4e9}),
                ("replicate.digest", 102.0, 103.0, {b: 3e8}),
                ("replicate.digest", 105.0, 105.5, {b: 2e8}),
                ("replicate.digest", 109.8, 110.4, {b: 5e8}),
                ("replicate.publish", 101.0, 109.0, {})])
    # inside the window: 0.5 + 1.0 + 0.5 + 0.2 of 10 s
    assert _read("publish_digest_share", rec) == pytest.approx(22.0)
    # the publishes that start in the window: 1e9 B over 2.1 s
    assert _read("digest_gb_per_s", rec) == pytest.approx(1.0 / 2.1)
    assert _read("publish_digest_share", _rec([])) is None
    assert _read("digest_gb_per_s", _rec([])) is None
    untraced = _rec(rec.program_spans, spans=None)
    assert _read("publish_digest_share", untraced) is None


def test_admit_wait_p90():
    waits = [0.01, 0.2, 0.05, 1.5, 0.3, 0.02, 0.9, 0.04, 0.06, 0.07]
    program = [("request.queued", 100.5 + i, 100.5 + i + w, {"rid": i})
               for i, w in enumerate(waits[:9])]
    program += [("request.queued", 99.0, 102.0, {"rid": 98}),   # before
                ("engine.prefill", 101.0, 101.5, {})]
    assert _read("admit_wait_p90_ms", _rec(program)) == pytest.approx(
        np.percentile([w * 1e3 for w in waits[:9]], 90))
    assert _read("admit_wait_p90_ms", _rec([])) is None


def test_recovery_restore():
    program = [("recover.compose", 104.0, 104.25, {"rank": 1}),
               ("recover.restore", 104.25, 104.4, {"rank": 1}),
               ("recover.compose", 101.0, 101.5, {"rank": 1}),   # before
               ("recover.restore", 105.0, 105.1, {"rank": 0}),   # another
               ("recover.replay", 104.4, 106.0, {"rank": 1})]
    rec = _rec(program, kill={"rank": 1, "t": 103.0})
    assert _read("recovery_restore_s", rec) == pytest.approx(0.4)
    assert _read("recovery_restore_s", _rec(program)) is None


def test_decode_device_share():
    program = [("engine.decode", 101.0, 101.1, {"active": 3}),
               ("engine.decode", 102.0, 102.2, {"active": 3}),
               ("engine.decode", 109.9, 110.3, {"active": 1}),
               ("engine.prefill", 103.0, 104.0, {})]
    dev = types.SimpleNamespace(events=[
        ("gemv", 101.00, 101.02), ("add", 101.01, 101.03),   # 0.03
        ("gemv", 101.09, 101.2),                             # 0.01 inside
        ("gemv", 102.05, 102.1),                             # 0.05
        ("selective_scan_fwd", 103.0, 104.0),                # not decode
        ("gemv", 109.95, 110.5)])                            # 0.05 in window
    rec = _rec(program, device=dev)
    want = (0.03 + 0.01 + 0.05 + 0.05) / (0.1 + 0.2 + 0.1)
    assert _read("decode_device_share", rec) == pytest.approx(100 * want)
    assert _read("decode_device_share", _rec(program)) is None


def test_busy_within_matches_a_plain_sum():
    from ftbench.harness.trace import busy_intervals
    from ftbench.metrics import _program
    rng = np.random.default_rng(5)
    s = np.sort(rng.uniform(0, 100, 400))
    ev = [("k", a, a + d) for a, d in zip(s, rng.uniform(0, 0.5, 400))]
    busy = busy_intervals(ev, 0.0, 100.0)
    sp = [("engine.decode", a, a + 0.7, {}) for a in np.arange(0, 99, 1.3)]
    grid = np.linspace(0, 100, 200001)[:-1] + 0.00025
    on = np.zeros_like(grid, bool)
    for a, b in busy:
        on |= (grid >= a) & (grid < b)
    inside = np.zeros_like(grid, bool)
    for _, a, b, _ in sp:
        inside |= (grid >= a) & (grid < b)
    assert _program.busy_within(busy, sp) == pytest.approx(
        (on & inside).sum() * 0.0005, abs=0.01)


def _cell(cells):
    base = cells()
    e2e = [{"name": n, "unit": UNITS[n]} for n in ("latency_p90_ms",
                                                    "setup_s")]
    per = [{"name": n, "unit": UNITS[n]} for n in ("publish_share",) + NEW]
    return spec.Cell(name=base.name, chips=1, config=base.config,
                     mix=base.mix, rate=base.rate, limits=base.limits,
                     end_to_end=e2e, per_layer=per,
                     readers={m["name"]: spec.reader(m["name"])
                              for m in e2e + per})


@pytest.fixture
def recordings(monkeypatch):
    """Every tracer a run makes active."""
    from repro_torch import tracing
    made = []
    recording = tracing.recording

    def counted(tracer):
        made.append(tracer)
        return recording(tracer)

    monkeypatch.setattr(tracing, "recording", counted)
    return made


def test_traced_cpu_run_reads_the_program(cells, recordings):
    from repro_torch import tracing
    cell = _cell(cells)
    # the kill in the window's first rounds, so that the recovery is read
    cell.mix = dict(cell.mix, fault=dict(cell.mix["fault"], round=20))
    res, _ = bench.run(cell, 2 ** 31 + 11, 2.0, True, 0.0, device="cpu")
    assert res["correct"], res["checks"]
    assert len(recordings) == 1 and tracing.active() is None
    got = res["metrics"]
    for name in ("publish_digest_share", "digest_gb_per_s",
                 "admit_wait_p90_ms", "recovery_restore_s"):
        assert got[name]["unit"] == UNITS[name]
        assert got[name]["value"] > 0, name
    assert got["publish_digest_share"]["value"] < \
        got["publish_share"]["value"]
    assert "decode_device_share" not in got          # no device trace
    # the recorded spans carry the program's names
    names = {n for n, *_ in recordings[0].spans}
    assert {"replicate.digest", "request.queued", "recover.compose",
            "engine.decode"} <= names


def test_untraced_run_installs_no_tracer(cells, recordings):
    res, _ = bench.run(_cell(cells), 2 ** 31 + 12, 1.0, False, 0.0,
                       device="cpu")
    assert set(res["metrics"]) == {"latency_p90_ms", "setup_s"}
    assert recordings == []


def test_program_spans_are_not_the_wrappers():
    from repro_torch import tracing
    src = open(f"{spec.FTBENCH}/harness/spans.py").read()
    wrappers = set(re.findall(r'me\.add\("([^"]+)"', src))
    assert wrappers == {"engine.step", "model.prefill", "model.decode_step",
                        "replicator.publish", "replicator.compose",
                        "engine.restore", "cluster.recover"}
    assert wrappers.isdisjoint(n for n, _ in tracing.SPANS)


def test_benchmark_json_lists_the_new_metrics():
    bench_json = spec._json(f"{spec.ROOT}/BENCHMARK.json")
    per = {m["name"]: m for m in bench_json["per_layer"]}
    cells = [w["name"] for w in bench_json["workloads"]]
    for name in NEW:
        m = per[name]
        assert m["unit"] == UNITS[name] and m["moves"] == "latency_p90_ms"
        assert m["source"] in ("program_span", "program_counter")
        assert set(m["workloads"]) <= set(cells)


def test_breakdown_tool_on_a_traced_window(cells):
    """`tools/program_spans.py`'s summary of a tiny traced CPU window:
    every span inside its parent's seconds, the window's counts, the
    queue's waits and the kill's parts."""
    import importlib.util
    import os
    import sys
    from ftbench.harness import traffic
    from ftbench.metrics import _program
    tools = os.path.join(spec.FTBENCH, "tools")
    sys.path.insert(0, tools)
    try:
        sp = importlib.util.spec_from_file_location(
            "ftbench_tool_program_spans",
            os.path.join(tools, "program_spans.py"))
        tool = importlib.util.module_from_spec(sp)
        sp.loader.exec_module(tool)
    finally:
        sys.path.remove(tools)
    cell = cells()
    cell.mix = dict(cell.mix, fault=dict(cell.mix["fault"], round=20))
    st = bench.make_setup(cell, 2 ** 31 + 13, "cpu")
    arrivals, fault = traffic.generate(cell.mix, cell.config, st.seed, 1.5,
                                       cell.rate)
    bench.warm_up(st, arrivals)
    rec = bench.serve_window(st, arrivals, fault, 1.5, True, 0.0,
                             [_program.instrument])
    out = tool.summary(rec)
    by = out["spans"]
    assert by["replicate.publish"]["s"] >= by["replicate.digest"]["s"]
    assert by["cluster.round"]["count"] > 0 and out["spans_a_round"] > 1
    for d in by.values():
        assert 0 <= d["self_s"] <= d["s"] + 1e-9 and d["busy_s"] == 0.0
    assert out["window_counts"]["replicate.bytes_digested"] > 0
    assert set(out["window_counts"]) <= set(out["run_counters"]) | {
        "serve.tokens_replayed"}
    assert all(v[0] is not None for v in out["queue_ms"].values())
    r = out["recovery_s"]
    assert r["compose"] > 0 and r["restore"] > 0 and r["kill_to_respawn"] > 0
    assert r["replayed_tokens"] == rec.cluster_metrics["kills"][0][
        "replayed_tokens"]
    # the same window with a made-up device trace: S1 inside every
    # prefill span but one launch that sticks out of its span by 1 ms
    pre = sorted((s, e) for n, s, e, _ in rec.program_spans
                 if n == "engine.prefill" and e > rec.t0 and s < rec.t_close)
    ev = [("selective_scan_fwd<16, true>", s + 1e-5, s + 2e-5)
          for s, _ in pre]
    ev.append(("selective_scan_fwd<16, true>", pre[0][1] - 1e-5,
               pre[0][1] + 1e-3))
    rec.device = types.SimpleNamespace(events=ev)
    out = tool.summary(rec)
    assert out["s1_outside"]["launches"] == 1
    assert out["s1_outside"]["max_ms_past_edge"] == pytest.approx(1.0)
    tot = 1e-5 * len(pre) + 1.01e-3
    assert out["s1_in_prefill_share"] == pytest.approx(
        (1e-5 * len(pre) + 1e-5) / tot)
    assert len(out["breakdown"]["idle_gaps"]) > 0
    assert out["spans"]["engine.prefill"]["busy_s"] == pytest.approx(
        1e-5 * len(pre) + 1e-5, rel=1e-6)
