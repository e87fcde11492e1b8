"""The sharded Trainer and ServeEngine on a mesh of one device, in this
process: the state is DTensors and every step runs in a constraint
scope, and the results must be the unsharded port's bit for bit — the
trainer's final parameters (fault-free, and through a process failure
and its memory-tier recovery) and the engine's transcripts (bf16, F1's
route: the kernel on a card, its plain version on the CPU).

The `gpu` cases run a world-1 NCCL group on the card and skip without
one; this file imports no JAX, so that they run there."""
import pytest
import torch

from repro_torch.checkpoint.manifest import tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.core import FailureType, FaultInjector
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models.model import Model
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine
from repro_torch.sharding.partition import gather_tree
from repro_torch.sharding.rules import PRESETS, ShardingRules
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, \
    Trainer
from _torch_threads import few_threads  # noqa: F401  (autouse)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]
PROMPTS = [[(7 * r + 3 * i) % 256 for i in range(4)] for r in range(6)]


@pytest.fixture
def group(request):
    """A process group of one on the test's device, ended afterwards."""
    device = request.param
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card: a world-1 NCCL group")
        from repro_torch.device import set_deterministic
        set_deterministic()
    with process_group(device=device):
        yield device


@pytest.mark.parametrize("group", DEVICES, indirect=True)
def test_world1_sharded_trainer_equals_unsharded(group, tmp_path):
    device = group
    cfg = reduced(get_config("paper-demo"))
    mesh = make_host_mesh((1,), ("data",), device=device)
    rules = ShardingRules(batch="data", embed="data")

    def run(tag, **kw):
        tr = Trainer(Model(cfg),
                     TokenPipeline(cfg.vocab_size, 4, 32, seed=11,
                                   device=device),
                     AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                     TrainConfig(total_steps=8, ckpt_dir=str(tmp_path / tag),
                                 device=device), **kw)
        res = tr.run()
        return tree_digest(gather_tree(tr.state["params"])), res

    plain, _ = run("plain")
    sharded, _ = run("mesh", mesh=mesh, rules=rules)
    inj = FaultInjector(n_ranks=8, n_steps=8, kind=FailureType.PROCESS,
                        seed=5)
    fault, res = run("fault", mesh=mesh, rules=rules, injector=inj)
    assert [r.rollback_step for r in res["reports"]] == [inj.fail_step]
    assert sharded == plain and fault == plain


@pytest.mark.parametrize("group", DEVICES, indirect=True)
def test_world1_sharded_engine_equals_unsharded(group):
    device = group
    cfg = reduced(get_config("qwen2-7b"))           # bf16 compute
    model = Model(cfg, ExecConfig(attn_impl="pallas"))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    # a table at scale 1.0, tied to the unembedding, makes greedy decode
    # repeat the last prompt token whatever attention computes
    params["embedding"]["table"].mul_(0.05)

    def run(**kw):
        eng = ServeEngine(model, params, n_slots=4, max_len=64, **kw)
        for rid, p in enumerate(PROMPTS):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
        eng.restore(eng.snapshot())
        return {r.rid: r.out for r in eng.run_until_drained()}, eng

    plain, _ = run()
    n = fa.LAUNCHES["flash_attention"]
    got, eng = run(mesh=make_host_mesh((1, 1), ("data", "model"),
                                       device=device),
                   rules=PRESETS["pod_serve"])
    assert got == plain and len(got) == len(PROMPTS)
    assert [str(p) for p in eng.state["k"].placements] == ["S(1)", "S(2)"]
    if device == "cuda":
        assert fa.LAUNCHES["flash_attention"] > n
