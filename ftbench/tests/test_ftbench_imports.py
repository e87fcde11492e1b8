"""Nothing a run loads has the top-level name `jax`, `jaxlib`, `flax` or
`repro` (the JAX package; `repro_torch` begins with its name, so names
are compared whole), and the references import nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

from ftbench.harness import spec

CODE = """
import sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from conftest import tiny_cell
from ftbench.harness import bench
res, _ = bench.run(tiny_cell(), 5, 1.5, True, 0.0, device="cpu")
assert res["correct"], res
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax_and_no_reference_package():
    code = CODE.format(root=spec.ROOT, src=os.path.join(spec.ROOT, "src"),
                       tests=os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "ftbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = glob.glob(os.path.join(spec.FTBENCH, "**", "*.py"),
                      recursive=True)
    for f in files:
        assert not set(_imports(f)) & {"jax", "jaxlib", "flax", "repro"}, f


def test_references_import_nothing_of_the_program():
    for f in glob.glob(os.path.join(spec.FTBENCH, "reference", "*.py")):
        assert set(_imports(f)) <= {"torch", "numpy", "math", "__future__"}, f
