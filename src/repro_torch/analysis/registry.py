"""Strategy-registry drift checker.

`core.recovery.STRATEGIES` is the single source of truth for the five
recovery strategies; every strategy-keyed surface of the port — the
scenario schema's vocabulary, the Table-2 checkpoint policy, the
real-runtime engine's mode map, the root/train CLIs, the alias table —
must derive from (or exactly cover) it. Drift fails the port's tier-1
test in seconds.

Unlike the AST checkers this one imports the (torch-free) live modules:
the derived surfaces are computed values, and comparing the computed
values is the whole point. Findings anchor to the surface's assignment
line found in the source tree when available.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.source import SourceTree

CHECKER = "registry"

_SURFACES = {
    "STRATEGY_KEYS": "repro_torch/scenarios/schema.py",
    "TABLE2": "repro_torch/checkpoint/policy.py",
    "MODES": "repro_torch/runtime/root.py",
    "REAL_MODES": "repro_torch/scenarios/engine.py",
    "STRATEGIES": "repro_torch/core/recovery.py",
    "STRATEGY_ALIASES": "repro_torch/core/recovery.py",
}


def _anchor(tree: SourceTree, surface: str) -> tuple:
    rel = _SURFACES.get(surface, "repro_torch/core/recovery.py")
    mod = tree.get(rel)
    if mod is not None:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == surface
                    for t in node.targets):
                return rel, node.lineno
        return rel, 1
    return rel, 1


def check(tree: SourceTree) -> List:
    from repro_torch.analysis import Finding
    findings: List[Finding] = []

    def drift(surface: str, message: str):
        rel, line = _anchor(tree, surface)
        findings.append(Finding(CHECKER, rel, line, "strategy-drift",
                                surface, message))

    try:
        from repro_torch.checkpoint.policy import TABLE2
        from repro_torch.core.recovery import (STRATEGIES,
                                               STRATEGY_ALIASES,
                                               get_strategy)
        from repro_torch.launch.train import STRATEGIES as launch_strategies
        from repro_torch.runtime.root import MODES
        from repro_torch.scenarios import engine, schema
    except Exception as e:        # pragma: no cover - import breakage
        findings.append(Finding(CHECKER, "repro_torch/core/recovery.py", 1,
                                "import-error", "registry",
                                f"could not import strategy surfaces: "
                                f"{e!r}"))
        return findings

    keys = set(STRATEGIES)
    if set(schema.STRATEGY_KEYS) != keys:
        drift("STRATEGY_KEYS",
              f"schema.STRATEGY_KEYS {sorted(schema.STRATEGY_KEYS)} != "
              f"registry keys {sorted(keys)}")
    want_t2 = {(f, s) for f in ("process", "node") for s in keys}
    if set(TABLE2) != want_t2:
        drift("TABLE2",
              f"checkpoint.policy.TABLE2 cells do not cover "
              f"(process|node) x registry keys: missing "
              f"{sorted(want_t2 - set(TABLE2))}, extra "
              f"{sorted(set(TABLE2) - want_t2)}")
    if set(MODES) != keys - {"ulfm"}:
        drift("MODES",
              f"root MODES {sorted(MODES)} != registry keys minus the "
              f"sim-only ulfm {sorted(keys - {'ulfm'})}")
    if set(engine.REAL_MODES) != set(MODES):
        drift("REAL_MODES",
              f"engine.REAL_MODES {sorted(engine.REAL_MODES)} != root "
              f"MODES {sorted(MODES)}")
    if set(launch_strategies) != keys:
        drift("STRATEGIES",
              f"launch.train strategy choices "
              f"{sorted(launch_strategies)} != registry keys "
              f"{sorted(keys)}")
    bad_aliases = set(STRATEGY_ALIASES.values()) - keys
    if bad_aliases:
        drift("STRATEGY_ALIASES",
              f"aliases resolve outside the registry: "
              f"{sorted(bad_aliases)}")
    for k in sorted(keys):
        try:
            ok = get_strategy(k).key == k
        except Exception:
            ok = False
        if not ok:
            drift("STRATEGIES",
                  f"get_strategy({k!r}) does not round-trip to its "
                  f"registry key")
    return findings
