"""reprolint for the port — static analysis of `repro_torch`'s own
correctness conventions.

The recovery paths this repo reproduces only work if every message a
role sends has a handler in the receiving role, every injected fault
point actually fires, annotated shared fields are touched under their
lock, and replayed recoveries are bit-deterministic. All of those are
string- or convention-level properties the type system cannot see, so
this package checks them from the ASTs:

  hook-point    fire() call-sites vs the schema POINTS registries,
                catalog cells vs live fire sites, kwarg drift
  protocol      message tags sent vs dispatched across the
                root/daemon/worker roles and the serve layer
  locks         `# guarded-by: <lock>` field annotations enforced
  determinism   wall-clock, unseeded RNGs, and set-iteration in the
                replay/consensus-critical modules
  registry      every strategy-keyed surface derives from
                core.recovery.STRATEGIES

Run as `python -m repro_torch.analysis [--strict] [--baseline FILE]`.
Every checker lints `repro_torch/` only, though the scanned `src/`
holds the JAX reference too. Pre-existing accepted findings live in the
committed `reprolint-torch-baseline.json` (keyed without line numbers,
so they survive unrelated edits); `--strict` fails on anything not
baselined. The package imports neither torch nor jax: the CLI runs on a
host without them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.source import SourceTree


def live_source_tree() -> SourceTree:
    """The tree this very package was imported from: the directory that
    holds `repro_torch` (the repo's src/)."""
    import repro_torch
    pkg = os.path.abspath(list(repro_torch.__path__)[0])
    return SourceTree(os.path.dirname(pkg))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit. `key` intentionally omits the line number so a
    baseline entry survives edits elsewhere in the file; `subject` is
    the stable name the finding is about (a tag, a point, a field)."""
    checker: str          # checker id, e.g. "protocol"
    path: str             # path relative to the scanned source root
    line: int             # 1-based
    code: str             # short finding class, e.g. "orphan-tag"
    subject: str          # the tag / point / field / surface concerned
    message: str          # one-line human explanation

    @property
    def key(self) -> str:
        return f"{self.checker}:{self.path}:{self.code}:{self.subject}"

    def render(self) -> str:
        return (f"src/{self.path}:{self.line}: "
                f"[{self.checker}/{self.code}] {self.message}")


def _checker_table() -> Dict[str, Callable[[SourceTree], List[Finding]]]:
    # imported lazily so `import repro_torch.analysis` stays
    # dependency-free
    from repro_torch.analysis import (determinism, hook_points, locks,
                                      protocol, registry)
    return {
        "hook-point": hook_points.check,
        "protocol": protocol.check,
        "locks": locks.check,
        "determinism": determinism.check,
        "registry": registry.check,
    }


def checker_names() -> List[str]:
    return list(_checker_table())


def run(tree: SourceTree,
        checkers: Optional[List[str]] = None) -> List[Finding]:
    """Run the named checkers (default: all) over `tree`; findings come
    back sorted by location. Unparsable files surface as findings, not
    exceptions, so a syntax error cannot silently skip a checker."""
    table = _checker_table()
    names = checkers if checkers is not None else list(table)
    out: List[Finding] = []
    for rel, exc in tree.errors():
        out.append(Finding("parse", rel, getattr(exc, "lineno", 1) or 1,
                           "syntax-error", rel,
                           f"could not parse: {exc}"))
    for name in names:
        out.extend(table[name](tree))
    out.sort(key=lambda f: (f.path, f.line, f.checker, f.code, f.subject))
    return out


# --------------------------------------------------------------- baseline

def load_baseline(path: str) -> Dict[str, str]:
    """baseline file -> {finding key: justification}. Missing file is an
    empty baseline (the tool still runs; --strict then demands a fully
    clean tree)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    return {e["key"]: e.get("reason", "") for e in data.get("entries", ())}


def save_baseline(path: str, findings: List[Finding],
                  reasons: Optional[Dict[str, str]] = None) -> None:
    reasons = reasons or {}
    entries = []
    for key in sorted({f.key for f in findings}):
        entries.append({"key": key,
                        "reason": reasons.get(key, "TODO: justify")})
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2)
        f.write("\n")


def split_by_baseline(findings: List[Finding], baseline: Dict[str, str]):
    """-> (new, accepted, stale_keys): findings not in the baseline,
    findings the baseline accepts, and baseline keys that no longer
    match anything (candidates for pruning)."""
    new = [f for f in findings if f.key not in baseline]
    accepted = [f for f in findings if f.key in baseline]
    live = {f.key for f in findings}
    stale = sorted(k for k in baseline if k not in live)
    return new, accepted, stale
