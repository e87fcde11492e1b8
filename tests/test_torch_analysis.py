"""The port's reprolint (`repro_torch.analysis`) against the reference's
(`repro.analysis`): the same findings on the reference's fixtures
re-rooted under `repro_torch/`, the same (checker, code, subject) set on
the live tree, every checker scoped to `repro_torch/`, torch's global
generator named by the determinism lint, and the live tree clean under
`--strict` with its own baseline, `reprolint-torch-baseline.json`."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import repro.analysis as ref_analysis
import repro_torch.analysis as analysis
from repro.analysis.source import SourceTree as RefSourceTree
from repro_torch.analysis import Finding, determinism, protocol, registry
from repro_torch.analysis.__main__ import find_repo_root, main
from repro_torch.analysis.source import SourceTree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "reprolint")
BASELINE = os.path.join(ROOT, "reprolint-torch-baseline.json")

# fixture name -> the checker it seeds
FIXTURE_CHECKER = {"hookpoints": "hook-point", "protocol": "protocol",
                   "locks": "locks", "determinism": "determinism"}
EXPECTED_BASELINE = {
    "protocol:repro_torch/runtime/daemon.py:orphan-tag:HB_ACK",
    "protocol:repro_torch/runtime/worker.py:orphan-tag:ACK",
    "protocol:repro_torch/runtime/worker.py:orphan-tag:CKPT",
}


@pytest.fixture(scope="module")
def live():
    return analysis.live_source_tree()


@pytest.fixture(scope="module")
def live_findings(live):
    return analysis.run(live)


def _sites(findings, mapped=False):
    return sorted(
        (f.path.replace("repro/", "repro_torch/", 1) if mapped else f.path,
         f.line, f.code, f.subject) for f in findings)


def _reroot(name, src, package):
    """The reference fixture `name`'s `repro/` copied to `src/package/`."""
    shutil.copytree(os.path.join(FIXTURES, name, "repro"),
                    os.path.join(src, package), dirs_exist_ok=True)


def _ref_fixture(name):
    checker = FIXTURE_CHECKER[name]
    return ref_analysis.run(RefSourceTree(os.path.join(FIXTURES, name)),
                            [checker])


# --------------------------------------------------------- fixture parity

@pytest.mark.parametrize("name", sorted(FIXTURE_CHECKER))
def test_fixture_parity_with_reference(name, tmp_path):
    _reroot(name, str(tmp_path / "src"), "repro_torch")
    got = analysis.run(SourceTree(str(tmp_path / "src")),
                       [FIXTURE_CHECKER[name]])
    want = _ref_fixture(name)
    assert want
    assert _sites(got) == _sites(want, mapped=True)
    assert all(f.path.startswith("repro_torch/") for f in got)


# ------------------------------------------------------------ live parity

def test_live_parity_with_reference(live, live_findings):
    ref = ref_analysis.run(RefSourceTree(live.root))
    assert ({(f.checker, f.code, f.subject) for f in live_findings}
            == {(f.checker, f.code, f.subject) for f in ref})
    assert all(f.path.startswith("repro_torch/") for f in live_findings)
    assert all(f.path.startswith("repro/") for f in ref)


def test_live_scan_covers_the_whole_port(live):
    pkg = os.path.join(live.root, "repro_torch")
    on_disk = {os.path.relpath(os.path.join(d, f), live.root)
               .replace(os.sep, "/")
               for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")}
    assert {m.rel for m in live.package()} == on_disk
    assert any(rel.startswith("repro/") for rel in live.modules())


# ------------------------------------------------------------------ scope

@pytest.mark.parametrize("name", sorted(FIXTURE_CHECKER))
def test_faults_under_the_reference_are_not_reported(name, tmp_path):
    """A fault seeded under `repro/` only (the hookpoints fixture's dead
    point, the locks fixture's unguarded access, ...) is the reference's
    to report, not the port's; the same fault under `repro_torch/` is."""
    src = str(tmp_path / "src")
    _reroot(name, src, "repro")
    os.makedirs(os.path.join(src, "repro_torch"))
    open(os.path.join(src, "repro_torch", "__init__.py"), "w").close()
    checker = FIXTURE_CHECKER[name]
    assert ref_analysis.run(RefSourceTree(src), [checker])
    assert analysis.run(SourceTree(src), [checker]) == []
    _reroot(name, src, "repro_torch")
    got = analysis.run(SourceTree(src), [checker])
    assert _sites(got) == _sites(_ref_fixture(name), mapped=True)


# ------------------------------------------------------------ determinism

TORCH_RNG_CALLS = ["rand(3)", "randn(3)", "randint(0, 9, (3,))",
                   "randperm(9)", "normal(0.0, 1.0, (3,))",
                   "bernoulli(p)", "multinomial(p, 2)", "manual_seed(0)"]


def _determinism_of(tmp_path, body):
    d = tmp_path / "src" / "repro_torch" / "runtime"
    d.mkdir(parents=True)
    (d / "rng.py").write_text(
        "import torch\n\n\ndef draw(p, g):\n    return " + body + "\n")
    return determinism.check(SourceTree(str(tmp_path / "src")))


@pytest.mark.parametrize("call", TORCH_RNG_CALLS,
                         ids=[c.split("(")[0] for c in TORCH_RNG_CALLS])
def test_torch_global_generator_is_unseeded_random(call, tmp_path):
    fs = _determinism_of(tmp_path, "torch." + call)
    name = "torch." + call.split("(")[0]
    assert [(f.path, f.line, f.code, f.subject) for f in fs] == [
        ("repro_torch/runtime/rng.py", 5, "unseeded-random", name)]


def test_torch_generator_keyword_is_seeded(tmp_path):
    assert _determinism_of(tmp_path, "torch.randn(3, generator=g)") == []


# --------------------------------------------------------------- registry

def test_registry_live_tree_clean(live):
    assert registry.check(live) == []


def test_registry_checker_catches_drift(monkeypatch, live):
    from repro_torch.scenarios import engine
    monkeypatch.setattr(engine, "REAL_MODES",
                        {k: v for k, v in engine.REAL_MODES.items()
                         if k != "replica"})
    fs = registry.check(live)
    assert any(f.subject == "REAL_MODES" and f.code == "strategy-drift"
               and f.path == "repro_torch/scenarios/engine.py"
               and f.line > 1 for f in fs)


# ------------------------------------------------- baseline + CLI + keys

def test_finding_key_is_line_independent():
    a = Finding("protocol", "repro_torch/runtime/worker.py", 10,
                "orphan-tag", "ACK", "msg")
    b = Finding("protocol", "repro_torch/runtime/worker.py", 99,
                "orphan-tag", "ACK", "other msg")
    assert a.key == b.key


def _protocol_repo(tmp_path):
    root = tmp_path / "repo"
    _reroot("protocol", str(root / "src"), "repro_torch")
    (root / "pyproject.toml").write_text("")
    fs = protocol.check(SourceTree(str(root / "src")))
    assert len(fs) == 2
    return root, fs


def test_baseline_roundtrip_and_split(tmp_path):
    _, fs = _protocol_repo(tmp_path)
    path = str(tmp_path / "baseline.json")
    analysis.save_baseline(path, fs, {fs[0].key: "accepted for test"})
    baseline = analysis.load_baseline(path)
    assert set(baseline) == {f.key for f in fs}
    assert baseline[fs[0].key] == "accepted for test"
    new, accepted, stale = analysis.split_by_baseline(fs, baseline)
    assert new == [] and len(accepted) == len(fs) and stale == []
    extra = Finding("protocol", "x.py", 1, "orphan-tag", "ZZZ", "m")
    new, _, _ = analysis.split_by_baseline(fs + [extra], baseline)
    assert new == [extra]
    _, _, stale = analysis.split_by_baseline([], baseline)
    assert stale == sorted(baseline)


def test_cli_strict_fails_then_passes_once_baselined(tmp_path):
    root, fs = _protocol_repo(tmp_path)
    args = ["--root", str(root), "--checker", "protocol", "--strict"]
    # the reference's baseline file is not the port's
    analysis.save_baseline(str(root / "reprolint-baseline.json"), fs)
    assert main(args) == 1
    analysis.save_baseline(str(root / "reprolint-torch-baseline.json"), fs)
    assert main(args) == 0


def test_cli_write_baseline_keeps_reasons(tmp_path):
    root, fs = _protocol_repo(tmp_path)
    bpath = str(root / "reprolint-torch-baseline.json")
    analysis.save_baseline(bpath, fs[:1], {fs[0].key: "kept reason"})
    assert main(["--root", str(root), "--checker", "protocol",
                 "--write-baseline"]) == 0
    with open(bpath) as f:
        entries = {e["key"]: e["reason"] for e in json.load(f)["entries"]}
    assert entries[fs[0].key] == "kept reason"
    assert set(entries) == {f.key for f in fs}
    assert not (root / "reprolint-baseline.json").exists()


def test_parse_error_surfaces_as_finding(tmp_path):
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "broken.py").write_text("def oops(:\n")
    fs = analysis.run(SourceTree(str(tmp_path / "src")),
                      checkers=["protocol"])
    assert [(f.checker, f.code, f.path) for f in fs] == [
        ("parse", "syntax-error", "repro_torch/broken.py")]


# -------------------------------------------------------------- self-run

def test_live_tree_clean_under_strict(live_findings):
    """The port's gate: the committed tree with its committed baseline
    passes `--strict`, and every baseline entry still matches."""
    new, accepted, stale = analysis.split_by_baseline(
        live_findings, analysis.load_baseline(BASELINE))
    assert new == [] and stale == []
    assert {f.key for f in accepted} == EXPECTED_BASELINE
    assert all(r and not r.startswith("TODO")
               for r in analysis.load_baseline(BASELINE).values())
    assert main(["--root", find_repo_root(), "--strict"]) == 0


_CHILD = r"""
import json, runpy, sys
sys.argv = ["repro_torch.analysis", "--strict"]
try:
    runpy.run_module("repro_torch.analysis", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro"))}))
"""


def test_cli_subprocess_loads_neither_torch_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "loaded": []}
    assert lines[-2].startswith("reprolint: 0 new finding(s), 3 baselined, "
                                "0 stale baseline entries")
