"""The port's Trainer on the moe, ssm, hybrid and vlm families, and its
ulfm and replica strategies under a node fault.

Across packages, per family (reduced, float32 compute): the reference's
Trainer writes a step-K checkpoint, and both trainers resume copies of it
for EXTRA steps on the same host batches. Losses agree within rtol 1e-5
and every parameter leaf within atol 1e-5, a vlm's `frontend_proj`
included: the token pipeline gives it no input, and like `jax.grad` the
port's step gives it a zero gradient, which AdamW's weight decay still
applies (ROADMAP C12).

Within the port, per family, a fault run lands on the bit-identical final
state of its fault-free twin, with the fault each family has on the card
(`chip_smoke.py` `[train-families]`).

An encdec model cannot train on the token pipeline in either package: the
reference fails with a KeyError, the port with a ValueError naming ROADMAP
C11.

The reference's init and jit are paid once per family (module-scoped
fixtures), so that the tier-1 run's wall-time test
`test_reinit_faster_than_cr` keeps light neighbours.
"""
import shutil

import jax
import numpy as np
import pytest

from repro_torch.checkpoint.manifest import flatten_leaves, tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.core import FailureType, FaultInjector
from repro_torch.models.model import Model
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, \
    Trainer
from _torch_threads import few_threads  # noqa: F401  (autouse)
# test_torch_trainer.py's reduced paper-demo run, held to its reference,
# and its host batches as jnp arrays for the reference Trainer
from test_torch_trainer import STEPS as STEPS_DEMO, _JaxHostPipeline, \
    _trainer

FAMILIES = {"moe": "olmoe-1b-7b", "ssm": "falcon-mamba-7b",
            "hybrid": "zamba2-7b", "vlm": "llava-next-34b"}
# the fault each family is held to on the card: (strategy, kind)
FAULTS = {"moe": ("reinit", FailureType.PROCESS),
          "ssm": ("cr", FailureType.NODE),
          "hybrid": ("reinit", FailureType.PROCESS),
          "vlm": ("reinit", FailureType.PROCESS)}
K, EXTRA = 2, 3            # the reference's checkpoint step, steps resumed
BATCH, SEQ = 2, 32         # SEQ a multiple of the reduced ssm_chunk (16)
STEPS = 4                  # the port's fault runs and twins


def _host(cfg):
    return TokenPipeline(cfg.vocab_size, BATCH, SEQ, seed=7, device="cpu")


# ----------------------------------------------------- across packages

@pytest.fixture(scope="module", params=sorted(FAMILIES))
def resumed(request, tmp_path_factory):
    """(family, the reference's run, its trainer, the port's run, its
    trainer), both resumed from the reference's step-K checkpoint."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models.model import Model as RefModel
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import TrainConfig as RefTC
    from repro.train import Trainer as RefTrainer

    family = request.param
    arch = FAMILIES[family]
    tmp = tmp_path_factory.mktemp(family)
    rcfg = ref_reduced(ref_get_config(arch)).replace(compute_dtype="float32")
    cfg = reduced(get_config(arch)).replace(compute_dtype="float32")
    data = _JaxHostPipeline(_host(cfg))
    ropt = RefAdamW(lr=1e-3, warmup_steps=2, total_steps=K + EXTRA)
    RefTrainer(RefModel(rcfg), data, ropt,
               RefTC(total_steps=K, ckpt_dir=str(tmp / "ref"))).run()
    shutil.copytree(tmp / "ref", tmp / "port")
    ref = RefTrainer(RefModel(rcfg), data, ropt,
                     RefTC(total_steps=K + EXTRA, ckpt_dir=str(tmp / "ref")))
    rres = ref.run()
    ours = Trainer(Model(cfg), _host(cfg),
                   AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=K + EXTRA),
                   TrainConfig(total_steps=K + EXTRA,
                               ckpt_dir=str(tmp / "port"), device="cpu"))
    res = ours.run()
    return family, rres, ref, res, ours


def test_resumed_losses_match_reference(resumed):
    _, rres, ref, res, ours = resumed
    assert len(res["losses"]) == len(rres["losses"]) == EXTRA
    np.testing.assert_allclose(res["losses"], rres["losses"], rtol=1e-5)
    assert int(ours.state["step"]) == int(ref.state["step"]) == K + EXTRA


def test_resumed_params_match_reference(resumed):
    family, _, ref, _, ours = resumed
    ra = flatten_leaves(jax.device_get(ref.state["params"]))
    ta = flatten_leaves(ours.state["params"])
    assert sorted(ta) == sorted(ra)
    if family == "vlm":
        # the leaf the loss does not reach: decayed, as the reference's
        assert "frontend_proj/w" in ra
    for key in ra:
        np.testing.assert_allclose(ta[key].numpy(), ra[key], rtol=0,
                                   atol=1e-5, err_msg=key)


# ------------------------------------------------------ within the port

def _port_trainer(cfg, tmp, tag, strategy="reinit", injector=None):
    return Trainer(Model(cfg), _host(cfg),
                   AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS),
                   TrainConfig(total_steps=STEPS, ckpt_dir=str(tmp / tag),
                               strategy=strategy, device="cpu"),
                   injector=injector)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_recovery_is_bitwise_identical(tmp_path, family):
    cfg = reduced(get_config(FAMILIES[family]))
    strategy, kind = FAULTS[family]
    twin = _port_trainer(cfg, tmp_path, "twin", strategy)
    twin_res = twin.run()
    inj = FaultInjector(n_ranks=8, n_steps=STEPS, kind=kind, seed=3)
    tr = _port_trainer(cfg, tmp_path, "fault", strategy, inj)
    res = tr.run()
    assert res["final_step"] == STEPS
    assert [r.rollback_step for r in res["reports"]] == [inj.fail_step]
    assert tree_digest(tr.state["params"]) == \
        tree_digest(twin.state["params"])
    assert tree_digest(tr.state["opt"]) == tree_digest(twin.state["opt"])
    assert res["losses"][-1] == twin_res["losses"][-1]


# ------------------------------------------------------------ ROADMAP C11

def test_c11_encdec_cannot_train_on_the_token_pipeline(tmp_path):
    """Both TokenPipelines yield only tokens and labels. The reference's
    first training step of an encdec model fails with `KeyError:
    'enc_emb'`; the port's raises a ValueError naming ROADMAP C11."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models.model import Model as RefModel
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import TrainConfig as RefTC
    from repro.train import Trainer as RefTrainer

    arch = "seamless-m4t-medium"
    cfg = reduced(get_config(arch))
    assert sorted(_host(cfg).host_batch(0)) == ["labels", "tokens"]
    ref = RefTrainer(RefModel(ref_reduced(ref_get_config(arch))),
                     _JaxHostPipeline(_host(cfg)),
                     RefAdamW(warmup_steps=1, total_steps=1),
                     RefTC(total_steps=1, ckpt_dir=str(tmp_path / "ref")))
    with pytest.raises(KeyError, match="enc_emb"):
        ref.run()
    ours = Trainer(Model(cfg), _host(cfg),
                   AdamWConfig(warmup_steps=1, total_steps=1),
                   TrainConfig(total_steps=1, ckpt_dir=str(tmp_path / "port"),
                               device="cpu"))
    with pytest.raises(ValueError, match="enc_emb.*ROADMAP C11"):
        ours.run()
    assert ours.logs == []


# -------------------------------------------- ulfm and replica, node fault

@pytest.fixture(scope="module")
def demo_twins(tmp_path_factory):
    """{strategy: (params digest, losses)} of fault-free runs."""
    tmp = tmp_path_factory.mktemp("twins")
    out = {}
    for strategy in ("reinit", "ulfm", "replica"):
        tr = _trainer(tmp, strategy, tag=strategy)
        res = tr.run()
        out[strategy] = (tree_digest(tr.state["params"]), res["losses"])
    return out


def test_fault_free_state_does_not_depend_on_the_strategy(demo_twins):
    """What lets `chip_smoke.py` hold ulfm and replica runs to the reinit
    twin of `[train]`: a strategy changes only what a recovery does."""
    assert demo_twins["ulfm"] == demo_twins["reinit"]
    assert demo_twins["replica"] == demo_twins["reinit"]


@pytest.mark.parametrize("strategy", ["ulfm", "replica"])
def test_node_fault_recovery_is_bitwise_identical(tmp_path, demo_twins,
                                                  strategy):
    """A node fault under ulfm restores from the file tier (the node's
    buddy copies died with it); under replica it promotes the off-node
    warm shadow. With a checkpoint every step both resume at the fail
    step."""
    inj = FaultInjector(n_ranks=8, n_steps=STEPS_DEMO,
                        kind=FailureType.NODE, seed=5)
    tr = _trainer(tmp_path, strategy, inj, tag=strategy)
    res = tr.run()
    assert res["final_step"] == STEPS_DEMO
    assert [r.rollback_step for r in res["reports"]] == [inj.fail_step]
    digest, losses = demo_twins["reinit"]
    assert tree_digest(tr.state["params"]) == digest
    assert res["losses"][-1] == losses[-1]
