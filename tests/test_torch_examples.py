"""The port's examples stay runnable: each script in examples/torch/ runs
in dry-run mode (REPRO_DRYRUN=1: print the plan, skip the heavy work) on
the CPU, as tests/test_examples.py runs the reference's."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
EXAMPLES = sorted(n for n in os.listdir(EXAMPLES_DIR) if n.endswith(".py"))


def test_every_reference_example_is_ported():
    reference = sorted(n for n in os.listdir(os.path.join(ROOT, "examples"))
                       if n.endswith(".py"))
    assert EXAMPLES == reference


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_dry_run(name):
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, name), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, \
        f"{name} dry-run failed:\n{proc.stdout[-2000:]}" \
        f"\n{proc.stderr[-2000:]}"
    assert proc.stdout.strip(), f"{name} dry-run printed nothing"
