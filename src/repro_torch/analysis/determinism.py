"""Determinism lint for the replay/consensus-critical modules.

Bit-identical recovery is a headline guarantee: a recovered run must
reproduce the fault-free run exactly, and the JOIN consensus must reach
the same answer on every rank. Three things silently break that —
wall-clock reads, unseeded RNGs, and iteration over `set`s (Python set
order varies with hash randomization and insertion history, which is
how a float-summation flake once happened). This lint forbids them in
the modules behind the guarantees:

  wall-clock       time.time()/time_ns() — decisions must use
                   time.monotonic() (durations) or step counters
  unseeded-random  the module-level `random` RNG, `default_rng()` /
                   `Random()` / `RandomState()` with no seed, and
                   torch's global generator: a `torch.rand`, `randn`,
                   `randint`, `randperm`, `normal`, `bernoulli`,
                   `multinomial` or `manual_seed` call with no
                   `generator=` (the port's explicit key is a
                   `torch.Generator`)
  set-iteration    for / comprehension / sum() / list() / tuple()
                   directly over a set-typed value — wrap in sorted()

Order-independent uses (membership, len, min/max, sorted, any/all, set
algebra) pass. Set-typedness is inferred locally: set literals and
comprehensions, set()/frozenset() calls, set-algebra expressions, and
names / self-attributes assigned any of those (including values of
dict-of-set comprehensions reached via subscript or .pop()).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from repro_torch.analysis.source import Module, SourceTree, is_self_attr

CHECKER = "determinism"
PREFIXES = (
    "repro_torch/runtime/",
    "repro_torch/core/",
    "repro_torch/checkpoint/",
    "repro_torch/serve/",
    "repro_torch/scenarios/schema.py",
)

_GLOBAL_RNG_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "getrandbits", "randbytes", "seed",
}
_NP_RNG_FNS = {
    "rand", "randn", "randint", "random", "choice", "shuffle",
    "permutation", "normal", "uniform", "seed",
}
# torch functions that draw from (or reseed) the global generator unless
# given `generator=`
_TORCH_RNG_FNS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "manual_seed",
}
# iteration wrappers whose result is order-independent
_ORDER_FREE = {"sorted", "min", "max", "len", "any", "all", "set",
               "frozenset"}
# wrappers that *freeze* the nondeterministic order into a sequence
_ORDER_FREEZING = {"sum", "list", "tuple"}


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _SetEnv:
    """Which names/attributes hold sets, inferred per class + function."""

    def __init__(self, set_attrs: Set[str]):
        self.attrs = set_attrs          # self.<attr> known to be a set
        self.names: Set[str] = set()    # local names known to be sets
        self.dict_of_sets: Set[str] = set()

    def is_set(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
                return True
            # d.pop(k) on a dict-of-sets, s.difference(...), s.union(...)
            if isinstance(fn, ast.Attribute):
                if (fn.attr == "pop" and isinstance(fn.value, ast.Name)
                        and fn.value.id in self.dict_of_sets):
                    return True
                if fn.attr in ("difference", "union", "intersection",
                               "symmetric_difference", "copy"):
                    return self.is_set(fn.value)
            return False
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)):
            return self.is_set(node.left) or self.is_set(node.right)
        if isinstance(node, ast.Name):
            return node.id in self.names
        if is_self_attr(node):
            return node.attr in self.attrs
        if isinstance(node, ast.Subscript):
            return (isinstance(node.value, ast.Name)
                    and node.value.id in self.dict_of_sets)
        return False

    def learn(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.Assign):
            value, targets = stmt.value, stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            value, targets = stmt.value, [stmt.target]
        else:
            return
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if self.is_set(value):
            self.names.update(names)
        elif isinstance(value, ast.DictComp) and self.is_set(value.value):
            self.dict_of_sets.update(names)
        else:
            self.names.difference_update(names)
            self.dict_of_sets.difference_update(names)


def _class_set_attrs(cls: ast.ClassDef) -> Set[str]:
    env = _SetEnv(set())
    attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and env.is_set(node.value):
            attrs.update(t.attr for t in node.targets if is_self_attr(t))
        elif (isinstance(node, ast.AnnAssign) and node.value is not None
                and env.is_set(node.value) and is_self_attr(node.target)):
            attrs.add(node.target.attr)
    return attrs


class _Visitor(ast.NodeVisitor):
    def __init__(self, mod: Module, env: _SetEnv, findings: List):
        self.mod = mod
        self.env = env
        self.findings = findings

    def _flag(self, node: ast.AST, code: str, subject: str, msg: str):
        from repro_torch.analysis import Finding
        self.findings.append(
            Finding(CHECKER, self.mod.rel, node.lineno, code, subject,
                    msg))

    def _check_iter(self, node: ast.AST, where: str):
        if self.env.is_set(node):
            self._flag(node, "set-iteration", _dotted(node) or "<set>",
                       f"{where} iterates a set — order varies across "
                       f"processes; use sorted(...)")

    def visit_Assign(self, node):
        self.env.learn(node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        self.env.learn(node)
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        self._check_iter(node.iter, "for loop")
        self.generic_visit(node)

    def _visit_comp(self, node):
        for gen in node.generators:
            self._check_iter(gen.iter, "comprehension")
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        if name in ("time.time", "time.time_ns"):
            self._flag(node, "wall-clock", name,
                       f"{name}() in a replay-critical module — use "
                       f"time.monotonic() or a step counter")
        elif name.startswith("random.") and \
                name.split(".", 1)[1] in _GLOBAL_RNG_FNS:
            self._flag(node, "unseeded-random", name,
                       f"{name}() uses the process-global RNG — "
                       f"construct random.Random(seed)")
        elif name.split(".")[-1] in ("default_rng", "RandomState") \
                and not node.args and not node.keywords:
            self._flag(node, "unseeded-random", name,
                       f"{name}() with no seed is entropy-seeded — "
                       f"pass an explicit seed")
        elif name.endswith(".Random") and not node.args \
                and not node.keywords:
            self._flag(node, "unseeded-random", name,
                       f"{name}() with no seed is entropy-seeded — "
                       f"pass an explicit seed")
        elif name in ("np.random." + f for f in _NP_RNG_FNS) or \
                name in ("numpy.random." + f for f in _NP_RNG_FNS):
            self._flag(node, "unseeded-random", name,
                       f"{name}() uses numpy's global RNG — use "
                       f"np.random.default_rng(seed)")
        elif name in ("torch." + f for f in _TORCH_RNG_FNS) and not any(
                kw.arg == "generator" for kw in node.keywords):
            self._flag(node, "unseeded-random", name,
                       f"{name}() uses torch's global generator — draw "
                       f"from a seeded torch.Generator (generator=g)")
        elif (isinstance(node.func, ast.Name)
                and node.func.id in _ORDER_FREEZING and node.args
                and self.env.is_set(node.args[0])):
            self._flag(node, "set-iteration",
                       _dotted(node.args[0]) or "<set>",
                       f"{node.func.id}() over a set freezes a "
                       f"nondeterministic order — use sorted(...)")
        self.generic_visit(node)


def check(tree: SourceTree) -> List:
    findings: List = []
    for mod in tree.scan(PREFIXES):
        if mod.rel.startswith("repro_torch/analysis/"):
            continue
        # module-level statements + each function with its own env
        module_env = _SetEnv(set())
        v = _Visitor(mod, module_env, findings)
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            v.visit(stmt)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls_attrs: Set[str] = set()
                env = _SetEnv(cls_attrs)
                fv = _Visitor(mod, env, findings)
                for child in node.body:
                    fv.visit(child)
            elif isinstance(node, ast.ClassDef):
                attrs = _class_set_attrs(node)
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        env = _SetEnv(set(attrs))
                        fv = _Visitor(mod, env, findings)
                        for child in fn.body:
                            fv.visit(child)
    # methods get visited twice (as bare FunctionDef and via ClassDef);
    # dedupe by site
    seen, out = set(), []
    for f in findings:
        site = (f.path, f.line, f.code, f.subject)
        if site not in seen:
            seen.add(site)
            out.append(f)
    return out
