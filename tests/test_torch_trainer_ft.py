"""The port trainer's elastic (shrink, grow-back) and gray paths, held to
the JAX trainer's same runs.

Every case runs three trainers from one reference-written step-0
checkpoint (float32 compute, the reduced paper-demo):

  - the port with the case's faults, whose final state must be
    BIT-IDENTICAL to the port's fault-free twin (the global batch never
    changes through a shrink, so the data trajectory does not either);
  - the JAX trainer with the same faults, whose report fields
    (`world_after`, `rollback_step`, the dropped ranks and
    `stragglers_by_rank`) the port's must equal exactly, and whose losses
    the port's must match within rtol 1e-5, the tolerance of
    test_torch_trainer.py (the sums run in another order).
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.checkpoint.manifest import tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.core import ScenarioInjector
from repro_torch.models.model import Model
from repro_torch.scenarios import Fault, Repair, Scenario, Topology
from repro_torch.scenarios.schema import gray_drain_cut
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, \
    Trainer
from _torch_threads import few_threads  # noqa: F401  (autouse)

STEPS = 10
CFG = reduced(get_config("paper-demo")).replace(compute_dtype="float32")
ELASTIC = dict(strategy="shrink", n_nodes=2, ranks_per_node=4,
               spare_nodes=0)


class _JaxHostPipeline:
    """The reference trainer's pipeline on the port's numpy batches."""

    def __init__(self, base):
        self.base = base

    def batch(self, step):
        return {k: jnp.asarray(v) for k, v in self.base.host_batch(step)
                .items()}


@pytest.fixture(scope="module")
def seed_ckpt(tmp_path_factory):
    """A step-0 checkpoint of the reference's initial state: the common
    start of every run in this module."""
    from repro.checkpoint import FileCheckpointer as RefCheckpointer
    from repro.configs import get_config as rg, reduced as rr
    from repro.models.model import Model as RefModel
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import TrainConfig as RefTC
    from repro.train import Trainer as RefTrainer
    d = tmp_path_factory.mktemp("seed")
    rcfg = rr(rg("paper-demo")).replace(compute_dtype="float32")
    tr = RefTrainer(RefModel(rcfg), None, RefAdamW(),
                    RefTC(total_steps=0, ckpt_dir=str(d)))
    RefCheckpointer(str(d)).save(0, tr.init_state())
    return d


def _copy(seed_ckpt, tmp_path, tag):
    d = tmp_path / tag
    shutil.copytree(seed_ckpt, d)
    return str(d)


def _port_run(seed_ckpt, tmp_path, tag, sc=None, **tc_kw):
    tr = Trainer(
        Model(CFG), TokenPipeline(CFG.vocab_size, 4, 32, seed=7,
                                  device="cpu"),
        AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS),
        TrainConfig(total_steps=STEPS, ckpt_dir=_copy(seed_ckpt, tmp_path,
                                                      tag),
                    device="cpu", **tc_kw),
        injector=ScenarioInjector(sc) if sc is not None else None)
    return tr, tr.run()


def _ref_run(seed_ckpt, tmp_path, sc, **tc_kw):
    from repro.configs import get_config as rg, reduced as rr
    from repro.core import ScenarioInjector as RefInjector
    from repro.models.model import Model as RefModel
    from repro.scenarios.schema import Scenario as RefScenario
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import TokenPipeline as RefPipeline
    from repro.train import TrainConfig as RefTC
    from repro.train import Trainer as RefTrainer
    rcfg = rr(rg("paper-demo")).replace(compute_dtype="float32")
    tr = RefTrainer(
        RefModel(rcfg),
        _JaxHostPipeline(RefPipeline(rcfg.vocab_size, 4, 32, seed=7)),
        RefAdamW(lr=1e-3, warmup_steps=2, total_steps=STEPS),
        RefTC(total_steps=STEPS, ckpt_dir=_copy(seed_ckpt, tmp_path, "ref"),
              **tc_kw),
        injector=RefInjector(RefScenario.from_json(sc.to_json())))
    return tr, tr.run()


@pytest.fixture(scope="module")
def twin(seed_ckpt, tmp_path_factory):
    """The port's fault-free run: its final parameter digest."""
    tr, res = _port_run(seed_ckpt, tmp_path_factory.mktemp("twin"), "twin")
    assert res["final_step"] == STEPS and res["reports"] == []
    return tree_digest(tr.state["params"])


def _elastic(faults, repairs=(), spares=0):
    return Scenario(name="trainer-elastic", steps=STEPS,
                    topology=Topology(nodes=2, ranks_per_node=4,
                                      spares=spares),
                    faults=faults, repairs=repairs, strategies=("shrink",),
                    expect_bit_identical=False)


def _ckpt_phase(point):
    return Scenario(name=f"trainer-{point.rsplit('.', 1)[-1]}", steps=STEPS,
                    topology=Topology(nodes=1, ranks_per_node=8, spares=0),
                    faults=(Fault("rank", 3, 5, point=point),),
                    strategies=("reinit",))


def _gray(mitigate):
    return Scenario(name="trainer-gray", steps=STEPS,
                    topology=Topology(nodes=2, ranks_per_node=4, spares=0),
                    faults=(Fault("rank", 1, 4, how="slow", factor=6.0),),
                    mitigate=mitigate, strategies=("shrink",),
                    expect_bit_identical=not mitigate)


SLOW = Fault("rank", 1, 4, how="slow", factor=6.0)

# name: (scenario, TrainConfig overrides,
#        [(world_after, rollback_step)] per report, dropped at the end)
CASES = {
    "shrink-node": (_elastic((Fault("node", 2, 4),)), ELASTIC,
                    [(4, 4)], [0, 1, 2, 3]),
    "spare-absorbs-node": (_elastic((Fault("node", 2, 4),), spares=1),
                           {**ELASTIC, "spare_nodes": 1}, [(None, 4)], []),
    "grow-back": (_elastic((Fault("node", 2, 4),), (Repair(2, 7),)),
                  ELASTIC, [(4, 4), (8, 7)], []),
    "process-shrink-uneven": (_elastic((Fault("rank", 2, 4),)), ELASTIC,
                              [(7, 4)], [2]),
    "growback-mid-cascade": (
        _elastic((Fault("node", 2, 4),
                  Fault("rank", 2, None, point="worker.recovery.pulled")),
                 (Repair(2, 7),)),
        ELASTIC, [(4, 4), (8, 7), (None, 7)], []),
    "min-data-parallel-floor": (_elastic((Fault("node", 2, 4),)),
                                {**ELASTIC, "min_data_parallel": 2},
                                [(None, 4)], []),
    "ckpt-mid-write": (_ckpt_phase("worker.ckpt.mid_write"), {},
                       [(None, 4)], None),
    "ckpt-pre-push": (_ckpt_phase("worker.ckpt.pre_push"), {},
                      [(None, 5)], None),
    "gray-tolerate": (_gray(False), ELASTIC, [], []),
    "gray-drain": (_gray(True), {**ELASTIC, "mitigate": True},
                   [(7, gray_drain_cut(SLOW))], [1]),
}


def _dropped(tr):
    return None if tr.elastic is None else sorted(tr.elastic.dropped)


@pytest.mark.parametrize("case", list(CASES))
def test_elastic_and_gray_paths_match_reference(case, seed_ckpt, tmp_path,
                                                twin):
    sc, tc_kw, reports, dropped = CASES[case]
    tr, res = _port_run(seed_ckpt, tmp_path, "port", sc, **tc_kw)
    assert res["final_step"] == STEPS
    got = [(r.world_after, r.rollback_step) for r in res["reports"]]
    assert got == reports
    assert _dropped(tr) == dropped
    assert tr.n_ranks == len(list(tr.view.ranks()))
    # bit-identical to the fault-free twin: the global batch is unchanged
    assert tree_digest(tr.state["params"]) == twin

    ref, rres = _ref_run(seed_ckpt, tmp_path, sc, **tc_kw)
    assert [(r.world_after, r.rollback_step) for r in rres["reports"]] \
        == got
    assert _dropped(ref) == dropped
    assert sorted(ref.view.ranks()) == sorted(tr.view.ranks())
    assert rres["stragglers_by_rank"] == res["stragglers_by_rank"]
    if sc.faults[0].how == "slow":
        assert set(res["stragglers_by_rank"]) == {1}
    assert len(res["losses"]) == len(rres["losses"])
    np.testing.assert_allclose(res["losses"], rres["losses"], rtol=1e-5)
