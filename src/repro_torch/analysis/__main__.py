"""The port's reprolint CLI:
`python -m repro_torch.analysis [--strict] [--baseline F]`.

Exit codes: 0 clean (or report-only mode), 1 new findings under
--strict, 2 usage/setup errors. The committed baseline holds accepted
findings (keyed without line numbers); `--write-baseline` regenerates
it from the current tree, preserving existing justifications. The
port's baseline is `reprolint-torch-baseline.json` at the repo root;
the reference's `reprolint-baseline.json` is never read or written.
"""
from __future__ import annotations

import argparse
import os
import sys

import repro_torch.analysis as analysis
from repro_torch.analysis.source import SourceTree


def find_repo_root() -> str:
    """The directory holding pyproject.toml + src/repro_torch — tried
    from this file's location (editable/source layout), then from cwd up."""
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [os.path.abspath(os.path.join(here, "..", "..", ".."))]
    d = os.getcwd()
    while True:
        candidates.append(d)
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    for c in candidates:
        if (os.path.isfile(os.path.join(c, "pyproject.toml"))
                and os.path.isdir(os.path.join(c, "src", "repro_torch"))):
            return c
    raise SystemExit("reprolint: cannot locate the repo root "
                     "(pyproject.toml + src/repro_torch); pass --root")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis for protocol, hook-point, "
                    "lock-discipline, and determinism conventions")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding not in the baseline")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         "<root>/reprolint-torch-baseline.json)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--checker", action="append", default=None,
                    choices=analysis.checker_names(),
                    help="run only this checker (repeatable)")
    ap.add_argument("--all", action="store_true",
                    help="also list baselined (accepted) findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings, "
                         "keeping existing justifications")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else find_repo_root()
    src = os.path.join(root, "src")
    if not os.path.isdir(src):
        print(f"reprolint: no src/ under {root}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or os.path.join(
        root, "reprolint-torch-baseline.json")

    tree = SourceTree(src)
    findings = analysis.run(tree, args.checker)
    baseline = analysis.load_baseline(baseline_path)
    new, accepted, stale = analysis.split_by_baseline(findings, baseline)

    if args.write_baseline:
        analysis.save_baseline(baseline_path, findings, baseline)
        print(f"reprolint: wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} to "
              f"{baseline_path}")
        return 0

    for f in new:
        print(f.render())
    if args.all:
        for f in accepted:
            reason = baseline.get(f.key, "")
            print(f"{f.render()}  [baselined: {reason}]")
    for key in stale:
        print(f"reprolint: stale baseline entry (no longer matches): "
              f"{key}", file=sys.stderr)

    n_checkers = len(args.checker) if args.checker else len(
        analysis.checker_names())
    print(f"reprolint: {len(new)} new finding(s), {len(accepted)} "
          f"baselined, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'} "
          f"({n_checkers} checker(s), "
          f"{len(tree.package())} modules)")
    if args.strict and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
