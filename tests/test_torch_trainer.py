"""Fault-tolerant trainer of the port.

Within the port, a failure-and-recovery run must land on the
BIT-IDENTICAL final state of an uninterrupted run (as the reference's
tests/test_trainer_ft.py asserts for the JAX trainer). Across packages,
both trainers resume the same reference-written checkpoint on the same
data and must give the same losses within float32 tolerance (rtol 1e-5:
the sums run in another order, see test_torch_model.py).
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manifest import tree_digest
from repro_torch.configs import get_config, reduced
from repro_torch.core import FailureType, FaultInjector, ScenarioInjector
from repro_torch.models.model import Model
from repro_torch.scenarios import Fault, Scenario, Topology
from repro_torch.train import AdamWConfig, TokenPipeline, TrainConfig, \
    Trainer
from _torch_threads import few_threads  # noqa: F401  (autouse)

CFG = reduced(get_config("paper-demo"))
STEPS = 10


def _trainer(tmp_path, strategy="reinit", injector=None, tag="", steps=STEPS,
             **tc_kw):
    data = TokenPipeline(CFG.vocab_size, 4, 32, seed=7, device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    tc = TrainConfig(total_steps=steps, ckpt_dir=str(tmp_path / tag),
                     strategy=strategy, device="cpu", **tc_kw)
    return Trainer(Model(CFG), data, opt, tc, injector=injector)


def _digest(tr):
    return tree_digest(tr.state["params"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tr = _trainer(tmp_path_factory.mktemp("ref"), tag="ref")
    res = tr.run()
    return _digest(tr), res


@pytest.mark.parametrize("strategy,kind,seed", [
    ("reinit", FailureType.PROCESS, 3), ("cr", FailureType.PROCESS, 3),
    ("ulfm", FailureType.PROCESS, 3), ("replica", FailureType.PROCESS, 3),
    ("reinit", FailureType.NODE, 5), ("cr", FailureType.NODE, 5),
])
def test_bitwise_identical_recovery(tmp_path, reference, strategy, kind,
                                    seed):
    ref_digest, ref_res = reference
    inj = FaultInjector(n_ranks=8, n_steps=STEPS, kind=kind, seed=seed)
    tr = _trainer(tmp_path, strategy, inj, tag=strategy)
    res = tr.run()
    assert res["final_step"] == STEPS
    assert len(res["reports"]) == 1
    # a checkpoint every step: each strategy resumes at the fail step
    # (replica by promoting its warm shadow, the others by restoring)
    assert res["reports"][0].rollback_step == inj.fail_step
    assert _digest(tr) == ref_digest
    assert res["losses"][-1] == ref_res["losses"][-1]


def test_cr_recovery_through_delta_checkpoints(tmp_path, reference):
    inj = FaultInjector(n_ranks=8, n_steps=STEPS, kind=FailureType.NODE,
                        seed=5)
    tr = _trainer(tmp_path, "cr", inj, tag="d", ckpt_delta_every=3)
    # AdamW dirties ~every tile, which degrades deltas to full frames; lift
    # the threshold so the restore really walks a base + delta chain
    tr.file_ckpt.delta_max_dirty = 1.0
    res = tr.run()
    assert res["final_step"] == STEPS
    kinds = {s: tr.file_ckpt._manifest(s).kind for s in tr.file_ckpt.steps()}
    assert "delta" in kinds.values(), kinds
    assert _digest(tr) == reference[0]


def test_resume_from_disk(tmp_path, reference):
    _trainer(tmp_path, steps=5).run()
    tr = _trainer(tmp_path)
    res = tr.run()
    assert res["final_step"] == STEPS and len(res["losses"]) == STEPS - 5
    assert _digest(tr) == reference[0]


@pytest.mark.parametrize("point,expect_offset", [
    ("worker.ckpt.mid_write", -1),    # save never committed: resume s-1
    ("worker.ckpt.pre_push", 0),      # file committed, buddy not: resume s
])
def test_checkpoint_phase_faults(tmp_path, reference, point, expect_offset):
    sc = Scenario(name=f"trainer-{point.rsplit('.', 1)[-1]}", steps=STEPS,
                  topology=Topology(nodes=1, ranks_per_node=8, spares=0),
                  faults=(Fault("rank", 3, 5, point=point),),
                  strategies=("reinit",))
    tr = _trainer(tmp_path, injector=ScenarioInjector(sc))
    res = tr.run()
    assert res["final_step"] == STEPS
    assert [r.rollback_step for r in res["reports"]] == [5 + expect_offset]
    assert _digest(tr) == reference[0]


def test_cascade_during_recovery(tmp_path, reference):
    sc = Scenario(name="trainer-cascade", steps=STEPS,
                  topology=Topology(nodes=1, ranks_per_node=8, spares=0),
                  faults=(Fault("rank", 3, 4),
                          Fault("rank", 3, None,
                                point="worker.recovery.pulled")),
                  strategies=("reinit",))
    tr = _trainer(tmp_path, injector=ScenarioInjector(sc))
    res = tr.run()
    assert res["final_step"] == STEPS
    assert [r.rollback_step for r in res["reports"]] == [4, 4]
    assert _digest(tr) == reference[0]


def test_shrink_and_gray_faults_not_ported(tmp_path, reference):
    """The shrink strategy and gray faults, which earlier slices of the
    port refused, are ported: a gray slow rank under reinit is tolerated
    (flagged, nothing recovers) and the run is bit-identical; the elastic
    paths in full are in test_torch_trainer_ft.py."""
    tr = _trainer(tmp_path, "shrink", tag="s", steps=1)
    assert tr.elastic is not None and tr.elastic.mesh.epoch == 0
    sc = Scenario(name="gray", steps=STEPS,
                  topology=Topology(nodes=2, ranks_per_node=4, spares=0),
                  faults=(Fault("rank", 1, 4, how="slow", factor=6.0),),
                  strategies=("reinit",))
    tr = _trainer(tmp_path, injector=ScenarioInjector(sc), tag="g")
    res = tr.run()
    assert res["reports"] == [] and set(res["stragglers_by_rank"]) == {1}
    assert _digest(tr) == reference[0]


def test_ulfm_charges_heartbeat_overhead(tmp_path):
    tr_u = _trainer(tmp_path, "ulfm", tag="u", steps=2)
    tr_u.run()
    assert tr_u.logs[0].heartbeat_overhead > 0
    tr_r = _trainer(tmp_path, "reinit", tag="r", steps=2)
    tr_r.run()
    assert tr_r.logs[0].heartbeat_overhead == 0


# ----------------------------------------------------- across packages

class _JaxHostPipeline:
    """Duck-typed pipeline for the reference Trainer: the numpy
    `host_batch` tokens (which the port uses) as jnp arrays."""

    def __init__(self, base):
        self.base = base

    def batch(self, step):
        return {k: jnp.asarray(v) for k, v in self.base.host_batch(step)
                .items()}


def test_resume_reference_checkpoint_matches_reference_losses(tmp_path):
    """The reference writes a step-4 checkpoint; both trainers resume
    copies of it for 3 steps on the same data and agree on every loss."""
    from repro.models.model import Model as RefModel
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import TokenPipeline as RefPipeline
    from repro.train import TrainConfig as RefTC
    from repro.train import Trainer as RefTrainer
    from repro.configs import get_config as rg, reduced as rr

    k, extra = 4, 3
    rcfg = rr(rg("paper-demo")).replace(compute_dtype="float32")
    cfg = CFG.replace(compute_dtype="float32")
    data = _JaxHostPipeline(RefPipeline(rcfg.vocab_size, 4, 32, seed=7))
    ropt = RefAdamW(lr=1e-3, warmup_steps=2, total_steps=k + extra)
    RefTrainer(RefModel(rcfg), data, ropt,
               RefTC(total_steps=k, ckpt_dir=str(tmp_path / "ref"))).run()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref = RefTrainer(RefModel(rcfg), data, ropt,
                     RefTC(total_steps=k + extra,
                           ckpt_dir=str(tmp_path / "ref")))
    rres = ref.run()
    ours = Trainer(
        Model(cfg), TokenPipeline(cfg.vocab_size, 4, 32, seed=7,
                                  device="cpu"),
        AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=k + extra),
        TrainConfig(total_steps=k + extra, ckpt_dir=str(tmp_path / "port"),
                    device="cpu"))
    res = ours.run()
    assert len(res["losses"]) == len(rres["losses"]) == extra
    np.testing.assert_allclose(res["losses"], rres["losses"], rtol=1e-5)
    assert int(ours.state["step"]) == int(ref.state["step"]) == k + extra
    rparams = jax.device_get(ref.state["params"])
    from repro_torch.checkpoint.manifest import flatten_leaves
    ra = flatten_leaves(rparams)
    ta = flatten_leaves(ours.state["params"])
    for key in ra:
        np.testing.assert_allclose(ta[key].numpy(), ra[key], rtol=0,
                                   atol=1e-5)


def _summary(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_cli_prints_reference_json_keys(tmp_path, capsys):
    from repro.launch.train import main as ref_main
    from repro_torch.launch.train import main
    args = ["--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
            "--fail-kind", "process"]
    deterministic = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    try:
        assert main(args + ["--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "p")]) == 0
    finally:                  # the CLI sets global torch state; restore it
        torch.use_deterministic_algorithms(deterministic)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    ours = _summary(capsys.readouterr().out)
    assert ref_main(args + ["--ckpt-dir", str(tmp_path / "r")]) == 0
    ref = _summary(capsys.readouterr().out)
    assert set(ours) == set(ref)
    assert [set(r) for r in ours["recoveries"]] == \
        [set(r) for r in ref["recoveries"]]
    assert ours["final_step"] == ref["final_step"] == 4
    assert ours["arch"] == ref["arch"]


def test_cli_cluster_not_ported(tmp_path, monkeypatch):
    """`--cluster`, which earlier slices of the port refused, deploys the
    port's real-process runtime: a process fault under reinit resumes at
    the fail step and every rank reports its checksum."""
    import os
    from repro_torch.launch.train import main
    monkeypatch.setenv("PYTHONPATH", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    report = tmp_path / "report.json"
    assert main(["--cluster", "--device", "cpu", "--steps", "4",
                 "--fail-kind", "process", "--ckpt-dir", str(tmp_path / "c"),
                 "--report", str(report)]) == 0
    rep = json.loads(report.read_text())
    assert [ev["resume_step"] for ev in rep["events"]] == [2]
    assert sorted(rep["checksums"]) == [str(r) for r in range(8)]
