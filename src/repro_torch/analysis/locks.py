"""Lock-discipline checker.

The runtime's threaded modules guard shared fields with per-object
locks, but nothing enforces that a new access site takes the lock — the
daemon reading `self.workers[r].pid` a line after its `with self.lock:`
block closed is exactly the race this catches. Fields opt in with a
trailing annotation on their defining assignment:

    self.workers = {}        # guarded-by: lock

Every `self.<field>` access (read or write) in that class must then sit
inside a `with self.<lockname>:` block. Two escapes:

  * `__init__` is construction — unchecked.
  * a method the caller must enter with the lock held declares it:

        def _prune(self, d):      # holds-lock: _lock

Nested functions (thread targets, callbacks) start with an empty held
set: they run later, when the enclosing `with` has long exited.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.source import Module, SourceTree, is_self_attr

CHECKER = "locks"
GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([A-Za-z_]\w*)")


def _guarded_fields(mod: Module,
                    cls: ast.ClassDef) -> Dict[str, Tuple[str, int]]:
    """{field: (lockname, annotation lineno)} from `self.x = ...`
    assignments whose source line carries a guarded-by comment."""
    fields: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(cls):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if is_self_attr(t):
                m = GUARD_RE.search(mod.line(t.lineno))
                if m:
                    fields.setdefault(t.attr, (m.group(1), t.lineno))
    return fields


def _holds_locks(mod: Module, fn: ast.FunctionDef) -> Set[str]:
    """holds-lock annotations on the def line, a decorator line, or the
    comment line directly above the def."""
    held: Set[str] = set()
    first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
    for lineno in range(max(1, first - 1), fn.body[0].lineno):
        m = HOLDS_RE.search(mod.line(lineno))
        if m:
            held.add(m.group(1))
    return held


def _with_locks(stmt: ast.With) -> Set[str]:
    out: Set[str] = set()
    for item in stmt.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call):     # e.g. lock.acquire_timeout(...)
            ctx = ctx.func
        if is_self_attr(ctx):
            out.add(ctx.attr)
        elif isinstance(ctx, ast.Name):
            out.add(ctx.id)
    return out


class _MethodVisitor(ast.NodeVisitor):
    def __init__(self, mod: Module, fields: Dict[str, Tuple[str, int]],
                 held: Set[str], findings: List):
        self.mod = mod
        self.fields = fields
        self.held = held
        self.findings = findings
        self.seen: Set[Tuple[str, int]] = set()

    def visit_With(self, node: ast.With):
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        added = _with_locks(node) - self.held
        self.held |= added
        for stmt in node.body:
            self.visit(stmt)
        self.held -= added

    def visit_Attribute(self, node: ast.Attribute):
        if is_self_attr(node) and node.attr in self.fields:
            lock, _ = self.fields[node.attr]
            if lock not in self.held:
                site = (node.attr, node.lineno)
                if site not in self.seen:
                    self.seen.add(site)
                    from repro_torch.analysis import Finding
                    self.findings.append(Finding(
                        CHECKER, self.mod.rel, node.lineno,
                        "unguarded-access", node.attr,
                        f"self.{node.attr} is guarded-by {lock} but "
                        f"accessed without `with self.{lock}:` held"))
        self.generic_visit(node)

    def _enter_nested(self, node):
        # a nested def/lambda runs later: locks held *here* don't count
        held = (_holds_locks(self.mod, node)
                if isinstance(node, ast.FunctionDef) else set())
        sub = _MethodVisitor(self.mod, self.fields, held, self.findings)
        sub.seen = self.seen
        for child in ast.iter_child_nodes(node):
            sub.visit(child)

    def visit_FunctionDef(self, node):
        self._enter_nested(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter_nested(node)


def check(tree: SourceTree) -> List:
    findings: List = []
    for mod in tree.package():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            fields = _guarded_fields(mod, node)
            if not fields:
                continue
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__":
                    continue
                held = _holds_locks(mod, fn)
                v = _MethodVisitor(mod, fields, held, findings)
                for child in fn.body:
                    v.visit(child)
    return findings
