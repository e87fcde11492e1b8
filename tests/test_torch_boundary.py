"""The port's boundary: repro_torch never loads jax or the JAX package,
runs on the card unless asked for the CPU, and sets no global torch
state when imported."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")

# the port's reprolint: stdlib only, it runs on a host without torch
ANALYSIS_MODULES = [
    "repro_torch.analysis", "repro_torch.analysis.__main__",
    "repro_torch.analysis.source", "repro_torch.analysis.protocol",
    "repro_torch.analysis.hook_points", "repro_torch.analysis.locks",
    "repro_torch.analysis.determinism", "repro_torch.analysis.registry",
]

SLICE_MODULES = [
    "repro_torch", "repro_torch.device", "repro_torch.tree",
    "repro_torch.kernels.checksum", "repro_torch.kernels.checksum.ref",
    "repro_torch.kernels.checksum.ops", "repro_torch.kernels.checksum._build",
    "repro_torch.core", "repro_torch.scenarios",
    "repro_torch.scenarios.schema", "repro_torch.scenarios.hooks",
    "repro_torch.checkpoint", "repro_torch.checkpoint.manifest",
    "repro_torch.checkpoint.serde", "repro_torch.checkpoint.file_ckpt",
    "repro_torch.checkpoint.policy", "repro_torch.train",
    "repro_torch.train.optimizer", "repro_torch.train.data",
    "repro_torch.train.straggler", "repro_torch.train.trainer",
    "repro_torch.models.config", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.transformer",
    "repro_torch.models.model", "repro_torch.configs",
    "repro_torch.launch.train",
    "repro_torch.kernels._build", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention._build",
    "repro_torch.checkpoint.memory_ckpt", "repro_torch.scenarios.catalog",
    "repro_torch.serve", "repro_torch.serve.engine",
    "repro_torch.serve.replicate", "repro_torch.serve.cluster",
    "repro_torch.launch.serve",
    "repro_torch.kernels.mamba_scan", "repro_torch.kernels.mamba_scan.ref",
    "repro_torch.kernels.mamba_scan.ops",
    "repro_torch.kernels.mamba_scan._build", "repro_torch.models.mamba",
    "repro_torch.sim", "repro_torch.sim.costs", "repro_torch.sim.cluster",
    "repro_torch.scenarios.engine", "repro_torch.runtime",
    "repro_torch.runtime.transport", "repro_torch.runtime.daemon",
    "repro_torch.runtime.root", "repro_torch.runtime.worker",
    "repro_torch._lazy",
    "repro_torch.sharding", "repro_torch.sharding.rules",
    "repro_torch.sharding.partition", "repro_torch.launch.mesh",
    "repro_torch.models.flops", "repro_torch.launch.dryrun",
    "repro_torch.launch.trace_analysis",
] + ANALYSIS_MODULES

# the control plane: the root, its daemons, the transport, the simulator
# and the scenario engine start without torch (only workers import it)
TORCH_FREE = [
    "repro_torch.runtime.root", "repro_torch.runtime.daemon",
    "repro_torch.runtime.transport", "repro_torch.sim",
    "repro_torch.scenarios.engine", "repro_torch.kernels.checksum._build",
    "repro_torch._lazy",
] + ANALYSIS_MODULES

_CHILD = r"""
import importlib, sys, tempfile, json
import torch
torch.set_num_threads(2)
mods = json.loads(sys.argv[1])
state = (torch.are_deterministic_algorithms_enabled(),
         torch.backends.cuda.matmul.allow_tf32)
for m in mods:
    importlib.import_module(m)
assert (torch.are_deterministic_algorithms_enabled(),
        torch.backends.cuda.matmul.allow_tf32) == state, "import set state"
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, Trainer
cfg = reduced(get_config("paper-demo"))
tr = Trainer(Model(cfg), TokenPipeline(cfg.vocab_size, 2, 16, device="cpu"),
             AdamWConfig(warmup_steps=1, total_steps=2),
             TrainConfig(total_steps=2, ckpt_dir=tempfile.mkdtemp(),
                         device="cpu"))
res = tr.run()
assert res["final_step"] == 2, res
from repro_torch.launch.serve import main as serve_main
assert serve_main(["--device", "cpu", "--reduced", "--attn-impl", "pallas",
                   "--requests", "2", "--prompt-len", "5", "--max-new",
                   "2", "--max-len", "16"]) == 0
assert serve_main(["--device", "cpu", "--reduced", "--attn-impl", "pallas",
                   "--arch", "falcon-mamba-7b", "--requests", "2",
                   "--prompt-len", "5", "--max-new", "2",
                   "--max-len", "16"]) == 0
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print(json.dumps(leaked))
"""


def test_port_never_loads_jax_or_reference():
    import json
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(SLICE_MODULES)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)


def test_no_source_file_imports_jax_or_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 30
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for m in _FORBIDDEN.finditer(f.read()):
                bad.append((os.path.relpath(path, ROOT), m.group(0).strip()))
    assert bad == []


def test_default_device_is_cuda():
    from repro_torch.device import resolve
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve()
    assert resolve("cpu").type == "cpu"


def test_default_trainer_device_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import Model
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)
    cfg = reduced(get_config("paper-demo"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Model(cfg), TokenPipeline(cfg.vocab_size, 2, 16),
                AdamWConfig(), TrainConfig(ckpt_dir=str(tmp_path)))


def test_params_from_jax_defaults_to_cuda():
    import numpy as np
    from repro_torch.models.model import params_from_jax
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    if torch.cuda.is_available():
        assert params_from_jax(tree)["a"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax(tree)
    got = params_from_jax(tree, device="cpu")["a"]
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), tree["a"])


def test_default_serve_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch.serve import main
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--reduced", "--requests", "1", "--prompt-len", "4"])
    finally:                  # the CLI sets global torch state; restore it
        torch.use_deterministic_algorithms(deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def test_control_plane_never_loads_torch():
    import json
    child = ("import importlib, json, sys\n"
             "for m in json.loads(sys.argv[1]):\n"
             "    importlib.import_module(m)\n"
             "from repro_torch.train.straggler import StragglerTracker\n"
             "print(json.dumps(sorted(m for m in sys.modules\n"
             "                        if m.split('.')[0] in "
             "('torch', 'numpy', 'jax'))))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", child,
                           json.dumps(TORCH_FREE)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_runtime_default_device_is_cuda(tmp_path):
    """The worker, the root, the daemon and `run_real` default to the
    card; without one, a worker raises before it registers and
    `run_real` fails."""
    import inspect
    from repro_torch.runtime import daemon, root, worker
    from repro_torch.scenarios import engine
    from repro_torch.scenarios.catalog import T22, fault_free
    assert inspect.signature(engine.run_real).parameters["device"].default \
        == "cuda"
    for mod in (worker, root, daemon):
        src = inspect.getsource(mod.main)
        assert 'add_argument("--device", default="cuda"' in src, mod
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        # port 1 is never a daemon: the worker must raise before connecting
        worker.main(["--rank", "0", "--world", "1", "--daemon-port", "1",
                     "--dim", "4", "--ckpt-dir", str(tmp_path)])
    # without nvcc the root fails at once building the kernel library;
    # with nvcc but no card every worker dies before it registers
    with pytest.raises((RuntimeError, subprocess.TimeoutExpired)):
        engine.run_real(fault_free(T22, steps=2, dim=4), "reinit",
                        str(tmp_path / "real"), timeout=60)


EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")

_EXAMPLE_CHILD = r"""
import json, runpy, sys
path = sys.argv[1]
sys.argv = [path, "--device", "cpu"]
runpy.run_path(path, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib"))
                        or m == "repro" or m.startswith("repro."))))
"""


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(EXAMPLES_DIR) if n.endswith(".py")))
def test_examples_never_load_jax_or_reference(name):
    """The port's examples (examples/torch/) import no jax and no module
    of the JAX package: none in their source, none loaded by a dry run."""
    path = os.path.join(EXAMPLES_DIR, name)
    with open(path, encoding="utf-8") as f:
        assert _FORBIDDEN.findall(f.read()) == []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN="1")
    proc = subprocess.run([sys.executable, "-c", _EXAMPLE_CHILD, path],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
