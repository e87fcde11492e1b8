"""Hook-point checker.

The fault-injection choke points are stringly typed three times over:
`hooks.fire("X", ...)` call sites, the `POINTS`/`SERVE_POINTS`
registries in `scenarios/schema.py`, and the `point=` fields of catalog
cells. A typo in any of them silently tests the fault-free path — the
scenario still passes, it just never injects. This checker closes the
triangle:

  unknown-point    a fire() site names a point the registries don't know
  dynamic-point    a fire() site whose point is not a string literal
                   (unverifiable statically — spell it out)
  dead-point       a registered point with no fire site anywhere
  unfired-point    a catalog cell whose fault point has no fire site
  kwarg-drift      the same point fired with different kwarg sets at
                   different sites (an injector keyed on `step=` would
                   silently never match the bare site)
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.source import (Module, SourceTree, const_str,
                                   const_str_seq)

CHECKER = "hook-point"
SCHEMA_REL = "repro_torch/scenarios/schema.py"
CATALOG_REL = "repro_torch/scenarios/catalog.py"

# Fault(target, rank, step, point, how) — positional index of `point`,
# and the dataclass defaults the catalog relies on
_FAULT_POINT_POS = 3
_FAULT_POINT_DEFAULT = "step"
_SERVE_POINT_DEFAULT = "serve.decode.step"


def _registry_points(mod: Module) -> Dict[str, int]:
    """POINTS/SERVE_POINTS module-level tuples -> {point: lineno}."""
    points: Dict[str, int] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if not names & {"POINTS", "SERVE_POINTS"}:
            continue
        seq = const_str_seq(node.value)
        if seq:
            for value, lineno in seq:
                points.setdefault(value, lineno)
    return points


def _fire_sites(tree: SourceTree):
    """Every `hooks.fire(...)` / `fire(...)` call in the port's package
    -> [(module, call node, point or None)]."""
    sites = []
    for mod in tree.package():
        if mod.rel.startswith("repro_torch/analysis/"):
            continue            # the linter's own fixtures/prose
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            named_fire = (isinstance(fn, ast.Attribute) and fn.attr == "fire"
                          and isinstance(fn.value, ast.Name)
                          and fn.value.id == "hooks")
            bare_fire = isinstance(fn, ast.Name) and fn.id == "fire"
            if not (named_fire or bare_fire):
                continue
            point = const_str(node.args[0]) if node.args else None
            sites.append((mod, node, point))
    return sites


def _catalog_cells(mod: Module) -> List[Tuple[str, int, str]]:
    """Fault(...) / ServeScenario(...) calls -> [(point, lineno, cell)].
    `cell` is a best-effort context string for the message."""
    cells = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name == "Fault":
            point: Optional[str] = _FAULT_POINT_DEFAULT
            if len(node.args) > _FAULT_POINT_POS:
                point = const_str(node.args[_FAULT_POINT_POS])
            for kw in node.keywords:
                if kw.arg == "point":
                    point = const_str(kw.value)
            cells.append((point or "<dynamic>", node.lineno, "Fault"))
        elif name == "ServeScenario":
            point = _SERVE_POINT_DEFAULT
            cell = "ServeScenario"
            for kw in node.keywords:
                if kw.arg == "fault_point":
                    point = const_str(kw.value) or "<dynamic>"
                if kw.arg == "name":
                    cell = const_str(kw.value) or cell
            cells.append((point, node.lineno, cell))
    return cells


def check(tree: SourceTree) -> List:
    from repro_torch.analysis import Finding
    findings: List[Finding] = []

    schema = tree.get(SCHEMA_REL)
    registry = _registry_points(schema) if schema else {}
    sites = _fire_sites(tree)

    fired: Dict[str, List[Tuple[Module, ast.Call]]] = {}
    for mod, node, point in sites:
        if point is None:
            findings.append(Finding(
                CHECKER, mod.rel, node.lineno, "dynamic-point",
                "<dynamic>",
                "fire() with a non-literal point cannot be checked "
                "against the registry — use a string literal"))
            continue
        fired.setdefault(point, []).append((mod, node))
        if registry and point not in registry:
            findings.append(Finding(
                CHECKER, mod.rel, node.lineno, "unknown-point", point,
                f"fire({point!r}) names a point absent from schema "
                f"POINTS/SERVE_POINTS — typo or unregistered hook"))

    # registered but never fired: the registry advertises an injection
    # site the runtime does not have
    if schema:
        for point, lineno in sorted(registry.items()):
            if point not in fired:
                findings.append(Finding(
                    CHECKER, SCHEMA_REL, lineno, "dead-point", point,
                    f"registered point {point!r} has no fire() site — "
                    f"scenarios selecting it can never inject"))

    # catalog cells must target fireable points
    catalog = tree.get(CATALOG_REL)
    if catalog:
        for point, lineno, cell in _catalog_cells(catalog):
            if point != "<dynamic>" and point not in fired:
                findings.append(Finding(
                    CHECKER, CATALOG_REL, lineno, "unfired-point", point,
                    f"{cell} cell targets point {point!r} which has no "
                    f"fire() site — the cell silently tests the "
                    f"fault-free path"))

    # kwarg drift: the canonical set is the first site in path order
    for point, plist in sorted(fired.items()):
        plist = sorted(plist, key=lambda mn: (mn[0].rel, mn[1].lineno))
        canon: Optional[frozenset] = None
        for mod, node in plist:
            kwargs = frozenset(kw.arg or "**" for kw in node.keywords)
            if canon is None:
                canon = kwargs
            elif kwargs != canon:
                findings.append(Finding(
                    CHECKER, mod.rel, node.lineno, "kwarg-drift", point,
                    f"fire({point!r}) passes kwargs "
                    f"{sorted(kwargs) or '[]'} but the first site "
                    f"passes {sorted(canon) or '[]'} — injectors keyed "
                    f"on a kwarg will silently skip one of them"))
    return findings
