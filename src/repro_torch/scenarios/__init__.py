"""Declarative failure-scenario engine.

One scenario definition — who fails, when (step / mid-checkpoint-write /
mid-recovery), how (SIGKILL / channel break / hang) — drives both the
discrete-event simulator and the real process runtime. See
docs/scenarios.md for the schema and catalog.

`schema` and `hooks` are stdlib-only (safe for worker subprocesses);
`engine`/`catalog` may pull heavier deps and are imported lazily by
consumers that need them.
"""
from . import hooks
from .schema import (CASCADE_POINTS, Fault, GRAY_DRAIN_PERSIST, GRAY_HOWS,
                     GRAY_STEP_S, HOWS, POINTS, Repair, Scenario,
                     SERVE_POINTS, STRATEGY_KEYS, ServeScenario, TARGETS,
                     Topology, elastic_transitions, expected_resume_step,
                     expected_resume_steps, gray_delay_s, gray_drain_cut,
                     normalize_strategy)

__all__ = [
    "CASCADE_POINTS", "Fault", "GRAY_DRAIN_PERSIST", "GRAY_HOWS",
    "GRAY_STEP_S", "HOWS", "POINTS", "Repair", "Scenario",
    "SERVE_POINTS", "STRATEGY_KEYS", "ServeScenario", "TARGETS", "Topology",
    "elastic_transitions", "expected_resume_step", "expected_resume_steps",
    "gray_delay_s", "gray_drain_cut", "normalize_strategy", "hooks",
]
