"""Scenario executors: one scenario definition, two substrates.

  run_sim(scenario, strategy)    discrete-event replay over the real
                                 Algorithm-1/2 protocol with calibrated
                                 costs (all strategies, any scale).
  run_real(scenario, strategy)   deploys the actual root/daemon/worker
                                 process tree on this host, injects the
                                 scenario's faults at their named points,
                                 and returns the measured outcome.

Both consume the identical Scenario object; `expected_resume_step` is the
shared oracle — the sim asserts the protocol lands there, the real run is
checked against the root's reported rollback consensus.

The port's copy of the JAX package's engine: `run_real` deploys the
port's runtime (`repro_torch.runtime.root`), whose workers keep their
state on `device` (`cuda` unless the caller asks for `cpu`). Neither
executor imports torch here: only the worker processes do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Optional

from .schema import (ROOT_INJECTED_EXIT, Scenario, expected_resume_steps,
                     normalize_strategy)

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: strategies the real-process runtime implements. ULFM exists only as a
#: cost model (the paper measures its prototype; we charge its collectives
#: and heartbeat in the sim). "shrink" is elastic recovery: re-host onto
#: spares while the pool lasts, contract the world once it is empty.
#: "replica" is zero-rollback failover: warm shadows promote in place and
#: a warm-standby root absorbs HNP loss without an external relaunch.
REAL_MODES = {"reinit": "reinit", "cr": "cr", "shrink": "shrink",
              "replica": "replica"}


def real_strategies(scenario: Scenario) -> list[str]:
    """The scenario's strategies executable on the real runtime."""
    return [s for s in scenario.strategies if s in REAL_MODES]


@dataclasses.dataclass
class ScenarioOutcome:
    """Uniform result shape across both executors."""
    scenario: str
    strategy: str
    substrate: str                      # "sim" | "real"
    n_recoveries: int
    resume_steps: list
    expected_resume: list               # one cut per primary fault (None
                                        # entries = timing-dependent)
    checksums: dict                     # real only: rank -> final checksum
    total_s: float
    detail: dict                        # substrate-specific extras

    @property
    def resume_consistent(self) -> bool:
        """True when the observed rollback consensuses match the
        declarative per-fault predictions, in order (vacuously true when
        every cut is timing-dependent)."""
        exp = list(self.expected_resume or [])
        if not any(e is not None for e in exp):
            return True
        if len(self.resume_steps) != len(exp):
            return False
        return all(e is None or r == e
                   for r, e in zip(self.resume_steps, exp))


# ------------------------------------------------------------------- sim

def run_sim(scenario: Scenario, strategy: str, costs=None
            ) -> ScenarioOutcome:
    from repro_torch.sim.cluster import simulate_scenario

    key = normalize_strategy(strategy)
    res = simulate_scenario(scenario, key, costs=costs)
    if not res.world_consistent:
        raise AssertionError(
            f"scenario {scenario.name}/{key}: world diverged from the "
            f"intended membership (unplanned shrink or lost rank)")
    # resume_steps carries the sim's own consensus replay (modeled
    # per-rank durable state, see sim.cluster._mech_resume) — the
    # harness checks it against the declarative oracle below, so the two
    # derivations guard each other
    return ScenarioOutcome(
        scenario=scenario.name, strategy=key, substrate="sim",
        n_recoveries=res.n_recoveries,
        resume_steps=list(res.resume_steps),
        expected_resume=expected_resume_steps(scenario, key), checksums={},
        total_s=res.total_recovery_s,
        detail={"rows": res.rows})


# ------------------------------------------------------------------ real

def _root_cmd(scenario_path: str, scenario: Scenario, mode: str,
              ckpt_dir: str, report: str, device: str) -> list[str]:
    t = scenario.topology
    return [sys.executable, "-m", "repro_torch.runtime.root",
            "--nodes", str(t.nodes),
            "--ranks-per-node", str(t.ranks_per_node),
            "--spares", str(t.spares),
            "--steps", str(scenario.steps), "--dim", str(scenario.dim),
            "--min-data-parallel", str(scenario.min_data_parallel),
            "--mode", mode, "--ckpt-dir", ckpt_dir, "--report", report,
            "--scenario", scenario_path,
            "--stall-timeout", str(scenario.stall_timeout_s),
            "--hb-period", str(scenario.heartbeat_period_s),
            "--hb-timeout", str(scenario.heartbeat_timeout_s),
            "--device", device]


def run_real(scenario: Scenario, strategy: str, workdir: str, *,
             timeout: float = 180.0, max_relaunches: int = 2,
             device: str = "cuda") -> ScenarioOutcome:
    """Execute the scenario on the live process runtime, with every
    worker's state on `device` (a worker asked for `cuda` without a card
    raises, so the run fails).

    Root-target faults exit the root with ROOT_INJECTED_EXIT; the
    executor relaunches the identical command (the INJECTED_* sentinel in
    the checkpoint dir keeps the fault from re-firing) — the external
    job-restart recovery the paper assumes for HNP loss."""
    key = normalize_strategy(strategy)
    mode = REAL_MODES.get(key)
    if mode is None:
        raise ValueError(f"strategy {key!r} has no real-runtime mode; "
                         f"executable: {sorted(REAL_MODES)}")
    os.makedirs(workdir, exist_ok=True)
    scenario_path = os.path.join(workdir, f"{scenario.name}.scenario.json")
    scenario.dump(scenario_path)
    ckpt_dir = os.path.join(workdir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    report_path = os.path.join(workdir, "report.json")
    cmd = _root_cmd(scenario_path, scenario, mode, ckpt_dir, report_path,
                    device)
    env = dict(os.environ, PYTHONPATH=SRC)

    if os.path.exists(report_path):
        os.remove(report_path)

    relaunches = 0
    standby_takeover = False
    while True:
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode == ROOT_INJECTED_EXIT:
            if mode == "replica":
                # no external relaunch: the warm standby already took
                # over — wait for it to finish the job and write the
                # report the dead primary never could
                _await_report(report_path, timeout, scenario, proc)
                standby_takeover = True
                break
            relaunches += 1
            if relaunches > max_relaunches:
                raise RuntimeError(
                    f"{scenario.name}: root kept dying after "
                    f"{max_relaunches} relaunches")
            continue
        if proc.returncode != 0:
            raise RuntimeError(
                f"{scenario.name}/{key} failed rc={proc.returncode}\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        break

    with open(report_path) as f:
        report = json.load(f)
    events = report.get("events", [])
    resumes = [ev["resume_step"] for ev in events if "resume_step" in ev]
    return ScenarioOutcome(
        scenario=scenario.name, strategy=key, substrate="real",
        n_recoveries=len(events) + relaunches,
        resume_steps=resumes,
        expected_resume=expected_resume_steps(scenario, key),
        checksums=report.get("checksums", {}),
        total_s=report.get("total_s", 0.0),
        detail={"events": events, "relaunches": relaunches,
                "standby_takeover": standby_takeover, "report": report})


def _await_report(report_path: str, timeout: float, scenario: Scenario,
                  proc) -> None:
    """Block until the standby root commits the final report (it writes
    tmp + atomic rename, so existence means complete)."""
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(report_path):
            return
        time.sleep(0.1)
    raise RuntimeError(
        f"{scenario.name}: primary root died but the standby never "
        f"finished the job (no report after {timeout}s)\n"
        f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")


def describe(scenario: Scenario) -> str:
    """One-paragraph human rendering — used by example dry-runs."""
    lines = [f"{scenario.name}: {scenario.description}".rstrip(": "),
             f"  topology  {scenario.topology.nodes} nodes x "
             f"{scenario.topology.ranks_per_node} ranks "
             f"(+{scenario.topology.spares} spare), "
             f"{scenario.steps} steps"]
    for i, f in enumerate(scenario.faults):
        when = f"@step {f.step}" if f.step is not None else "@recovery"
        lines.append(f"  fault {i}   {f.how} {f.target} {f.rank} "
                     f"{when} ({f.point})")
    for i, r in enumerate(scenario.repairs):
        lines.append(f"  repair {i}  node of rank {r.rank} rejoins "
                     f"@step {r.step} (elastic grow-back)")
    exp = expected_resume_steps(scenario)
    cuts = ", ".join("timing-dependent" if e is None else str(e)
                     for e in exp) or "none"
    lines.append(f"  expected consistent cut(s): {cuts}; "
                 f"strategies: {', '.join(scenario.strategies)}")
    return "\n".join(lines)
