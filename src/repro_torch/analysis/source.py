"""Parsed-source substrate shared by the reprolint checkers.

A `SourceTree` walks one directory of Python sources (normally the
repo's `src/`, or a test fixture tree laid out the same way), parses
each file once, and hands checkers `(rel path, source, AST, lines)`
bundles. Trees are tiny (~200 files) so everything is parsed eagerly on
first use and cached for the run.

The repo's `src/` holds two packages, the JAX reference `repro/` and
this port `repro_torch/`; the port's checkers lint `repro_torch/` only
(`package()`), and the whole tree only when it has no `repro_torch/`
at all (fixture trees laid out as the reference's).
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

PACKAGE = "repro_torch/"


@dataclass
class Module:
    rel: str                  # posix path relative to the tree root
    path: str                 # absolute path
    source: str
    tree: ast.Module
    lines: List[str]          # source.splitlines(); lines[lineno-1]

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class SourceTree:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._modules: Optional[Dict[str, Module]] = None
        self._errors: List[Tuple[str, SyntaxError]] = []

    def _load(self) -> Dict[str, Module]:
        if self._modules is not None:
            return self._modules
        mods: Dict[str, Module] = {}
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__",))
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, self.root).replace(os.sep, "/")
                try:
                    with open(path, encoding="utf-8") as f:
                        source = f.read()
                    tree = ast.parse(source, filename=path)
                except (SyntaxError, UnicodeDecodeError) as e:
                    self._errors.append((rel, e))  # surfaced as findings
                    continue
                mods[rel] = Module(rel, path, source, tree,
                                   source.splitlines())
        self._modules = mods
        return mods

    def modules(self) -> Dict[str, Module]:
        return self._load()

    def errors(self) -> List[Tuple[str, SyntaxError]]:
        self._load()
        return list(self._errors)

    def get(self, rel: str) -> Optional[Module]:
        return self._load().get(rel)

    def match(self, prefixes: Iterable[str]) -> List[Module]:
        """Modules under any of `prefixes` (exact file paths match too).
        Returns [] when nothing matches — callers scanning a fixture
        tree that doesn't mirror the real layout fall back to
        `modules()` themselves."""
        out = []
        for rel, mod in self._load().items():
            if any(rel == p or rel.startswith(p) for p in prefixes):
                out.append(mod)
        return out

    def package(self) -> List[Module]:
        """The modules under `repro_torch/`; every module when the tree
        has none (a fixture tree laid out as the reference's)."""
        return self.match((PACKAGE,)) or list(self._load().values())

    def scan(self, prefixes: Iterable[str]) -> List[Module]:
        """`match(prefixes)`, falling back to `package()` when the
        tree doesn't contain the canonical layout (fixture trees)."""
        return self.match(prefixes) or self.package()


# ------------------------------------------------------------ AST helpers

def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def const_str_seq(node: ast.AST) -> Optional[List[Tuple[str, int]]]:
    """A tuple/list/set of string constants -> [(value, lineno)], else
    None if any element is non-constant."""
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return None
    out = []
    for elt in node.elts:
        s = const_str(elt)
        if s is None:
            return None
        out.append((s, elt.lineno))
    return out


def is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and (attr is None or node.attr == attr))
