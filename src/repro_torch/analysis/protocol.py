"""Protocol message-flow checker.

Control-plane messages are dicts with an ALL-CAPS `"type"` tag sent over
`transport.send_msg` and dispatched by string comparison at the
receiving role. Nothing ties a send to a handler: a never-appended
`done` ledger and the class of "root broadcasts X, worker dispatches
X_TYPO" bugs only surface as a hung barrier in a scenario run. This
checker extracts both sides from the ASTs of the runtime + serve layers
and cross-checks the whole role graph (pooled across roles — relays
forward tags verbatim, so a tag is healthy iff *someone* constructs it
and *someone* dispatches it):

  orphan-tag     a constructed message tag no role ever dispatches
  dead-handler   a dispatch arm for a tag no role ever constructs

Reply-style tags consumed positionally (an inline `recv_msg` after a
request, e.g. HB_ACK) have no dispatch arm by design — those live in
the committed baseline with a justification.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from repro_torch.analysis.source import Module, SourceTree, const_str

CHECKER = "protocol"
PREFIXES = ("repro_torch/runtime/", "repro_torch/serve/")

# message tags are SHOUTY_SNAKE, >= 3 chars (ACK, SYNC, REINIT, ...)
TAG_RE = re.compile(r"^[A-Z][A-Z0-9_]{2,}$")


def _tag(node: ast.AST):
    s = const_str(node)
    return s if s is not None and TAG_RE.match(s) else None


def _collect(mod: Module):
    """-> (sent, handled): {tag: [lineno]} for message constructions
    ({"type": "TAG", ...} dict literals) and dispatch sites (equality /
    membership comparisons against tag constants)."""
    sent: Dict[str, List[int]] = {}
    handled: Dict[str, List[int]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if k is not None and const_str(k) == "type":
                    t = _tag(v)
                    if t:
                        sent.setdefault(t, []).append(v.lineno)
        elif isinstance(node, ast.Compare):
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)):
                    for side in (node.left, comp):
                        t = _tag(side)
                        if t:
                            handled.setdefault(t, []).append(side.lineno)
                elif isinstance(op, (ast.In, ast.NotIn)):
                    if isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                        for elt in comp.elts:
                            t = _tag(elt)
                            if t:
                                handled.setdefault(t, []).append(
                                    elt.lineno)
    return sent, handled


def check(tree: SourceTree) -> List:
    from repro_torch.analysis import Finding
    sent: Dict[str, List[Tuple[str, int]]] = {}
    handled: Dict[str, List[Tuple[str, int]]] = {}
    for mod in tree.scan(PREFIXES):
        ms, mh = _collect(mod)
        for t, lines in ms.items():
            sent.setdefault(t, []).extend((mod.rel, ln) for ln in lines)
        for t, lines in mh.items():
            handled.setdefault(t, []).extend((mod.rel, ln)
                                             for ln in lines)

    findings: List[Finding] = []
    for t in sorted(set(sent) - set(handled)):
        rel, line = min(sent[t])
        findings.append(Finding(
            CHECKER, rel, line, "orphan-tag", t,
            f"message tag {t!r} is constructed but no role dispatches "
            f"it — the receiver drops it on the floor"))
    for t in sorted(set(handled) - set(sent)):
        rel, line = min(handled[t])
        findings.append(Finding(
            CHECKER, rel, line, "dead-handler", t,
            f"dispatch arm for tag {t!r} which nothing constructs — "
            f"dead code or a renamed sender"))
    return findings
