"""The port's real-process runtime (root, daemons, workers) against the
JAX package's, on the CPU.

Each case deploys live process trees, 2 nodes x 2 ranks (+1 spare, or 0
for the shrink cell), 6 steps at dim 256, once through the port's
`run_real(..., device="cpu")` and once through the reference's. The
port's workers keep `x` in torch tensors; the reference's in numpy. The
two must agree EXACTLY (tolerance 0): the same resume steps (which must
also be the oracle's), the same per-rank checksums bit for bit, and the
same bytes in every rank's newest frame file (`rank_*.s6.bin`). Wall
times are not asserted: process start-up on a loaded host varies.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.scenarios import engine as ref_engine
from repro.scenarios.catalog import BY_NAME as REF_BY_NAME
from repro.scenarios.catalog import CATALOG as REF_CATALOG
from repro.scenarios.schema import Scenario as RefScenario
from repro_torch.scenarios import engine
from repro_torch.scenarios.catalog import BY_NAME, T22, fault_free
from repro_torch.scenarios.schema import expected_resume_steps
from _torch_threads import few_threads  # noqa: F401  (autouse)

DIM = 256
STEPS = 6
TIMEOUT = 240

# name: (scenario at dim 256, strategy)
CASES = {
    "fault-free": (fault_free(T22, steps=STEPS, dim=DIM), "reinit"),
    "reinit-process": (BY_NAME["proc-sigkill-midstep"], "reinit"),
    "reinit-node": (BY_NAME["node-sigkill"], "reinit"),
    "cr-node": (BY_NAME["node-sigkill"], "cr"),
    "shrink-process": (BY_NAME["proc-loss-shrink"], "shrink"),
    "replica-promote": (BY_NAME["replica-promote"], "replica"),
}


def _at_dim(sc):
    assert sc.steps == STEPS
    return dataclasses.replace(sc, dim=DIM)


def _frames(workdir) -> dict:
    ckpt = os.path.join(workdir, "ckpt")
    out = {}
    for name in sorted(os.listdir(ckpt)):
        if name.startswith("rank_") and name.endswith(f".s{STEPS}.bin"):
            with open(os.path.join(ckpt, name), "rb") as f:
                out[name] = f.read()
    return out


def _run_against_reference(name, tmp_path, device):
    """Run case `name` through the port on `device` and through the
    reference; assert that resume steps, checksums and newest frames
    agree exactly. Returns (scenario, strategy, the port's outcome)."""
    sc, strategy = CASES[name]
    sc = _at_dim(sc)
    ours = engine.run_real(sc, strategy, str(tmp_path / "port"),
                           timeout=TIMEOUT, device=device)
    ref = ref_engine.run_real(RefScenario.from_json(sc.to_json()), strategy,
                              str(tmp_path / "ref"), timeout=TIMEOUT)
    oracle = expected_resume_steps(sc, strategy)
    assert ours.resume_steps == ref.resume_steps == \
        [e for e in oracle if e is not None]
    assert ours.resume_consistent
    assert ours.n_recoveries == ref.n_recoveries == len(oracle)
    assert ours.checksums == ref.checksums       # floats, bit for bit
    assert len(ours.checksums) == len(ref.checksums) > 0
    frames = _frames(tmp_path / "port")
    assert set(frames) == {f"rank_{r}.s{STEPS}.bin" for r in ours.checksums}
    assert frames == _frames(tmp_path / "ref")
    return sc, strategy, ours


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_matches_reference(name, tmp_path):
    sc, strategy, ours = _run_against_reference(name, tmp_path, "cpu")
    # the port's report adds each finishing rank's launches and start-up
    workers = ours.detail["report"]["workers"]
    assert set(workers) == set(ours.checksums)
    for w in workers.values():
        # on the CPU the frames' digests take the plain version: no launch
        assert w["launches"] == {"tile_checksums": 0, "checksum_words": 0,
                                 "gather_tiles": 0}
        assert w["startup"]["ready_s"] >= w["startup"]["import_s"] > 0
    restarted = sum(w["restarted"] for w in workers.values())
    if strategy == "reinit" and name != "fault-free":
        # reinit re-spawns the lost ranks only (cr re-deploys every rank
        # as a new one, which resumes from its file)
        assert restarted == (sc.topology.ranks_per_node
                             if sc.faults[0].target == "node" else 1)
    elif strategy in ("cr", "replica") or name == "fault-free":
        assert restarted == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_runtime_on_card_matches_reference(name, tmp_path):
    """The same cases with every worker's state on the card: the frames
    are digested by K1 in every worker, and the outcome and the frame
    bytes are still the reference's (tolerance 0)."""
    _device("cuda")
    _, _, ours = _run_against_reference(name, tmp_path, "cuda")
    workers = ours.detail["report"]["workers"]
    assert set(workers) == set(ours.checksums)
    for w in workers.values():
        assert w["launches"]["tile_checksums"] > 0


FAST = [s.name for s in REF_CATALOG if "fast" in s.tags]


@pytest.mark.scenario_slow
@pytest.mark.parametrize("name", FAST)
def test_fast_catalog_matches_reference(name, tmp_path):
    """Every `fast` catalog cell under each of its real strategies, at the
    catalog's own size: the port's outcome equals the reference's."""
    for strategy in ref_engine.real_strategies(REF_BY_NAME[name]):
        ours = engine.run_real(BY_NAME[name], strategy,
                               str(tmp_path / strategy / "port"),
                               timeout=TIMEOUT, device="cpu")
        ref = ref_engine.run_real(REF_BY_NAME[name], strategy,
                                  str(tmp_path / strategy / "ref"),
                                  timeout=TIMEOUT)
        assert ours.resume_steps == ref.resume_steps
        assert ours.resume_consistent
        assert ours.checksums == ref.checksums


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device(name)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dim", [1, 7, 64, 256, 4096])
def test_device_step_gives_numpy_bits(dim, device):
    """The worker's step on a tensor (`torch.mv` with 0.999·I, + 1e-3)
    and its host `np.sum` give the reference's numpy bits: every output
    is 0.999·x_i plus exact zeros, whatever the order of summation."""
    dev = _device(device)
    rng = np.random.default_rng(dim)
    x_np = rng.standard_normal(dim)
    w_np = np.eye(dim) * 0.999
    w = torch.eye(dim, dtype=torch.float64, device=dev) * 0.999
    assert np.array_equal(w.cpu().numpy(), w_np)
    x = torch.from_numpy(x_np.copy()).to(dev)
    for _ in range(5):
        x_np = w_np @ x_np + 1e-3
        x = torch.mv(w, x) + 1e-3
        assert x.cpu().numpy().tobytes() == x_np.tobytes()
        total_np = float(x_np.sum())
        total = float(np.sum(x.cpu().numpy()))
        assert total == total_np
        x_np[0] = total_np / 4
        x[0] = total / 4
    assert x.cpu().numpy().tobytes() == x_np.tobytes()


@pytest.mark.parametrize("device", DEVICES)
def test_worker_frames_equal_reference_frames(device):
    """A worker's frame stream over a device `x` (digested by K1 on the
    card, by its plain version on the CPU) is byte for byte the
    reference's numpy stream, full frames and delta frames alike."""
    from repro.checkpoint import serde as ref_serde
    from repro_torch.checkpoint import serde
    from repro_torch.kernels.checksum import ops
    dev = _device(device)
    ours = serde.FramePublisher(2, contiguous=True)
    ref = ref_serde.FramePublisher(2, contiguous=True)
    x_np = np.random.default_rng(3).standard_normal(4096)
    n0 = ops.LAUNCHES["tile_checksums"]
    kinds = []
    for step in range(1, 6):
        if step % 2:
            x_np = np.eye(4096).dot(x_np) * 0.999 + 1e-3   # every tile
        else:
            x_np[100:200] += 1.0                           # one tile
        got = ours.publish({"x": torch.from_numpy(x_np.copy()).to(dev)},
                           step)
        assert got == ref.publish({"x": x_np.copy()}, step)
        assert ours.last_kind == ref.last_kind
        kinds.append(ours.last_kind)
    assert kinds == ["full", "delta", "full", "delta", "full"]
    assert ops.LAUNCHES["tile_checksums"] - n0 == \
        (5 if dev.type == "cuda" else 0)
