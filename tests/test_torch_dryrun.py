"""The port's dry run (`launch/dryrun.py`, `launch/trace_analysis.py`) on
the CPU: a step traced on fake tensors under a fake process group.

  - At world 1 the trace is the step: the FLOPs it counts equal
    `FlopCounterMode`'s count of the same step run for real (F1 and S1
    counted by their formulas in both), and its argument bytes equal the
    real parameters' and inputs' bytes. One traced cell a family, shared
    by the tests through module-scoped fixtures.
  - A decode step writes its cache in place: the trace reads it as
    aliased outputs.
  - On a fake (2, 2) world: the reference's `test_while_trip_count_extraction`
    program (13 trips of tanh(h @ w), w split on `model`) gives an
    all-reduce total of at least 13 trips of its (16, 64) float32 result;
    a reduced train cell with microbatches and the buddy copy traces every
    collective kind it issues, the buddy ring's receives as the
    reference's collective-permute, one local shard of each data-split
    leaf.
  - One CLI smoke as in `tests/test_system.py`, and a refused cell is
    reported as skipped.

Every comparison is exact.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.trace_analysis import StepTrace, tensor_bytes
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import ExecConfig
from repro_torch.sharding.partition import state_shardings
from repro_torch.tree import tree_leaves

from _torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _world1(arch: str, kind: str):
    """A reduced serving cell of `arch` (bf16 parameters, pallas) traced
    under a (1, 1) mesh: (model, shape, trace)."""
    cfg = reduced(get_config(arch)).replace(param_dtype="bfloat16")
    model = Model(cfg, ExecConfig(attn_impl="pallas"))
    shape = ShapeConfig("w1", 32, 4, kind)
    with dryrun.fake_world(1):
        mesh = dryrun.make_host_mesh((1, 1), ("data", "model"),
                                     device="cpu")
        trace, meta = dryrun.lower_cell(
            cfg, shape, model, mesh, dryrun.cell_rules(cfg, shape, mesh,
                                                       False), device="cpu")
    assert meta["trace_s"] > 0
    return model, shape, trace


@pytest.fixture(scope="module", params=["qwen2-7b", "falcon-mamba-7b"])
def prefill_cell(request):
    return _world1(request.param, "prefill")


@pytest.fixture(scope="module")
def decode_cell():
    return _world1("qwen2-7b", "decode")


def _real(model, shape, fn):
    """(FlopCounterMode's count of `fn(params, inputs)` run for real on
    the CPU, the bytes of the parameters and inputs)."""
    params = model.init(torch.Generator().manual_seed(0))
    specs = model.input_specs(shape, abstract=False, device="cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn(params, specs)
    nbytes = sum(tensor_bytes(t) for t in tree_leaves((params, specs)))
    return fc.get_total_flops(), nbytes


def test_world1_prefill_trace_equals_real_run(prefill_cell):
    model, shape, trace = prefill_cell
    flops, nbytes = _real(model, shape, lambda p, b: model.prefill(
        p, b, max_len=shape.seq_len))
    assert trace.flops == flops > 0
    mem = trace.memory()
    assert mem["argument_bytes"] == nbytes
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["alias_bytes"] == 0
    assert trace.collective_summary() == {"total": 0}


def test_world1_decode_trace_writes_its_cache_in_place(decode_cell):
    model, shape, trace = decode_cell
    flops, nbytes = _real(model, shape, lambda p, b: model.decode_step(
        p, b["token"], b["state"], shape.seq_len - 1))
    assert trace.flops == flops > 0
    state = model.input_specs(shape, device="cpu")["state"]
    cache = sum(tensor_bytes(t) for t in tree_leaves(state))
    mem = trace.memory()
    # the scalar position is an int, not an argument of the traced step
    assert mem["argument_bytes"] == nbytes - 4
    assert mem["alias_bytes"] == cache


def test_while_program_all_reduce_total():
    """The reference's program of test_while_trip_count_extraction: the
    Python loop's 13 trips each all-reduce the (16, 64) float32 partial
    product of a row shard (w split on `model` along the contraction).
    The carry's layout, which XLA picks for the reference, is stated: its
    rows split over data, whole over model (DTensor would otherwise
    reduce-scatter it and gather w instead)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(4):
        mesh = dryrun.make_host_mesh((2, 2), ("data", "model"),
                                     device="cpu")
        with FakeTensorMode():
            w = DTensor.from_local(torch.empty(13, 32, 64), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(13, 64, 64), stride=(4096, 64, 1))
            x = DTensor.from_local(torch.empty(16, 32), mesh,
                                   [Shard(0), Shard(1)], run_check=False,
                                   shape=(32, 64), stride=(64, 1))
            trace = StepTrace((w, x))
            with trace:
                h = x
                for i in range(13):
                    # the carry stays split by rows over data, whole over
                    # model: the partial product is all-reduced
                    h = torch.tanh((h @ w[i]).redistribute(
                        mesh, [Shard(0), Replicate()]))
                out = h.sum()
            trace.finish(out)
    coll = trace.collective_summary()
    assert coll["all-reduce"] >= 13 * 16 * 64 * 4
    assert coll["total"] == coll["all-reduce"]
    assert trace.flops == 13 * 2 * 16 * 32 * 64


def test_train_cell_on_a_fake_world_of_four():
    """A reduced train cell under a (2, 2) mesh and the pod rules, with 2
    microbatches and the buddy copy: the ring receives one local shard of
    each leaf split over `data` (the reference's collective-permute)."""
    cfg = reduced(get_config("qwen2-7b"))
    model = Model(cfg, ExecConfig(microbatches=2, remat_policy="none",
                                  xent_chunks=1))
    shape = ShapeConfig("t", 32, 4, "train")
    with dryrun.fake_world(4):
        mesh = dryrun.make_host_mesh((2, 2), ("data", "model"),
                                     device="cpu")
        rules = dryrun.cell_rules(cfg, shape, mesh, False)
        trace, _ = dryrun.lower_cell(cfg, shape, model, mesh, rules,
                                     with_buddy=True, device="cpu")
        params = model.abstract_params(device="cpu")
        from repro_torch.train.optimizer import adamw_init
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        shd = state_shardings(mesh, state, rules)
    from torch.distributed.tensor import Shard
    want = 0
    for leaf, s in zip(tree_leaves(state), tree_leaves(shd)):
        pl = s.placements                       # (data, model)
        if isinstance(pl[0], Shard):
            want += tensor_bytes(leaf) // (2 * (1 + isinstance(pl[1],
                                                               Shard)))
    coll = trace.collective_summary()
    assert coll["collective-permute"] == want > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    mem = trace.memory()
    assert min(mem["argument_bytes"], mem["output_bytes"],
               mem["temp_bytes"]) > 0
    assert trace.flops > 0 and trace.bytes_accessed > 0


@pytest.mark.parametrize("arch,kind", [("olmoe-1b-7b", "decode"),
                                       ("zamba2-7b", "train"),
                                       ("seamless-m4t-medium", "decode")])
def test_family_cell_on_a_fake_world_of_four(arch, kind):
    """A reduced cell of each family whose step meets DTensor's limits
    at production scale (ROADMAP C10) traces under a (2, 2) mesh and the
    pod rules: the MoE routing products, Mamba2's SSD and the encdec
    cross-attention run on each rank's lanes and heads."""
    cfg = reduced(get_config(arch))
    model = Model(cfg, ExecConfig(remat_policy="none", xent_chunks=1))
    shape = ShapeConfig("c", 32, 4, kind)
    with dryrun.fake_world(4):
        mesh = dryrun.make_host_mesh((2, 2), ("data", "model"),
                                     device="cpu")
        trace, _ = dryrun.lower_cell(
            cfg, shape, model, mesh,
            dryrun.cell_rules(cfg, shape, mesh, False), device="cpu")
    assert trace.flops > 0 and trace.collective_summary()["total"] > 0
    assert trace.memory()["argument_bytes"] > 0


def test_refused_cell_is_skipped():
    r = dryrun.run_cell("qwen2-7b", "long_500k", False)
    assert r["skipped"] and r["mesh"] == "pod"


def test_trace_device_falls_back_without_cuda():
    """The traced tensors claim cuda where torch can index a CUDA
    tensor, cpu on a torch built without CUDA; any other device as named."""
    want = "cuda" if torch.backends.cuda.is_built() else "cpu"
    assert dryrun.trace_device().type == want
    assert dryrun.trace_device("cpu").type == "cpu"


def test_dryrun_single_cell_smoke(tmp_path):
    """The dry-run entry point works end to end on the reference's smoke
    cell (its own process: a fake world of 256). It runs at one thread
    and `nice` 19, so that the wall-time test `test_reinit_faster_than_cr`
    beside it keeps its CPU."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        ["nice", "-n", "19", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--arch",
         "seamless-m4t-medium", "--shape", "train_4k", "--mesh", "pod",
         "--microbatches", "4", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "OK" in proc.stdout
    path = os.path.join(str(tmp_path),
                        "seamless-m4t-medium__train_4k__pod.json")
    with open(path) as f:
        art = json.load(f)
    assert art["collective_bytes"]["total"] > 0
    assert art["memory"]["argument_bytes"] > 0
    assert art["analytic"]["flops_total"] > 0
    assert art["chips"] == 256
