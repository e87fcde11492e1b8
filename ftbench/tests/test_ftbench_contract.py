"""BENCHMARK.json and the result line keep to the benchmark's contract:
names, units, bounds, the files each name leads to, the run budget; the
command refuses to run without a card and prints no result; a run's last
line has the keys, units and device fields, the checks last."""
import json
import os
import re
import subprocess
import sys

import pytest

from ftbench.harness import bench, spec

BENCH = spec._json(os.path.join(spec.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ftbench"]
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits its 43200 s
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, cells // 4)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(f"{spec.FTBENCH}/metrics/{m['name']}.py")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = spec.load(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert cell.config["name"] == w["config"]
        assert cell.rate > 0 and cell.limits["max_logit_gap"] > 0
        assert os.path.exists(
            f"{spec.FTBENCH}/reference/{cell.config['reference']}.py")
    for c in BENCH["configs"]:
        assert c["file"].startswith("ftbench/configs/")
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_command_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    w = BENCH["workloads"][0]["name"]
    p = subprocess.run([sys.executable, os.path.join(spec.ROOT, *BENCH[
        "command"][1:]), "--workload", w, "--seed", "1", "--seconds", "1",
        "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_result_line(cells):
    cell = cells()
    res, lines = bench.run(cell, 2 ** 31 + 3, 2.0, False, 0.0, device="cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    json.dumps(res)
    assert set(res["metrics"]) == {"latency_p90_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert lines == [f"[check] {k} {c['value']!r} (limit {c['limit']!r})"
                     for k, c in res["checks"].items()]
    res, _ = bench.run(cell, 7, 2.0, True, 0.0, device="cpu")
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "publish_share" in res["metrics"]
