"""A cell's files, found by the names in BENCHMARK.json: its
configuration (the entry's `file`), its traffic mix
(`ftbench/traffic/<traffic>.json`), its own rate and limits
(`ftbench/cells/<workload>.json`) and a reader for each of its metrics
(`ftbench/metrics/<metric>.py`). Adding a cell, a configuration, a mix or
a metric adds files and entries; nothing here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

FTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(FTBENCH)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file
    mix: dict                    # the traffic file
    rate: float                  # requests a second offered to the cell
    limits: dict                 # number compared -> its limit
    end_to_end: list             # BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict                # metric name -> its reader module


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """The reader module of metric `name`."""
    path = os.path.join(FTBENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ftbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _json(os.path.join(root, cfg["file"]))
    mix = _json(os.path.join(FTBENCH, "traffic", f"{w['traffic']}.json"))
    own = _json(os.path.join(FTBENCH, "cells", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                mix=mix, rate=own["rate_per_s"], limits=own["limits"],
                end_to_end=e2e, per_layer=per,
                readers={m["name"]: reader(m["name"]) for m in e2e + per})
