"""The port's sharded Trainer and ServeEngine on a 4-rank gloo world on
the CPU, against the reference's unsharded Trainer and engine.

Trainer: reduced paper-demo (float32 compute, as the port's other
cross-package trainer tests) on a 4-way data mesh with
ShardingRules(batch="data", embed="data"), resumed by both packages from
one step-0 checkpoint that carries the reference's initial state across
(`params_from_jax`). A process failure recovers through the memory tier,
whose buddy copy is the ring of shards over the data ranks: the final
parameters equal the fault-free run's bit for bit, the losses equal the
reference's within rtol 1e-5 (the mesh sums the embed shards in another
order), and a sharded save writes the same bytes as an unsharded save of
the same values.

Engine: reduced qwen2-7b (float32, F1's route, whose plain version runs
here) on a 2x2 (data, model) mesh with pod_serve: the KV cache is split
over all 4 ranks, two runs with a snapshot and restore after 3 steps
agree, and the transcripts equal the reference engine's.

The world is spawned once for the module (one deadline of 300 s).
test_torch_sharded_world1.py runs the same paths at world 1, on the CPU
and on a card."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.model import Model as RefModel
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro.train import AdamWConfig as RefAdamW
from repro.train import TrainConfig as RefTC
from repro.train import Trainer as RefTrainer
from repro_torch.checkpoint import FileCheckpointer
from repro_torch.models.model import params_from_jax
from repro_torch.train import TokenPipeline
from _torch_mesh_worlds import World
from _torch_serve_model import serve_models
from _torch_threads import few_threads  # noqa: F401  (autouse)

STEPS, BATCH, SEQ, SEED = 10, 8, 32, 11
PROMPTS = [[(7 * r + 3 * i) % 256 for i in range(4)] for r in range(6)]
ENGINE = dict(mesh=(2, 2), n_slots=4, max_len=64, max_new=5, snap_after=3)


class _JaxHostPipeline:
    """The port's numpy token batches as jnp arrays, for the reference."""

    def __init__(self, base):
        self.base = base

    def batch(self, step):
        return {k: jnp.asarray(v)
                for k, v in self.base.host_batch(step).items()}


def _ref_trainer(ckpt_dir):
    rcfg = ref_reduced(ref_get_config("paper-demo")).replace(
        compute_dtype="float32")
    data = _JaxHostPipeline(TokenPipeline(rcfg.vocab_size, BATCH, SEQ,
                                          seed=SEED, device="cpu"))
    return RefTrainer(RefModel(rcfg), data,
                      RefAdamW(lr=1e-3, warmup_steps=2, total_steps=STEPS),
                      RefTC(total_steps=STEPS, ckpt_dir=str(ckpt_dir)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's results, the reference trainer's losses, the
    reference engine's transcripts)."""
    root = tmp_path_factory.mktemp("sharded")
    ckpt0 = root / "ckpt0"
    init = jax.device_get(_ref_trainer(root / "unused").init_state())
    FileCheckpointer(str(ckpt0), n_shards=4).save(
        0, params_from_jax(init, device="cpu"))
    ref, port, params, tparams = serve_models()
    torch.save(tparams, root / "serve_params.pt")
    # the references run while the world does
    world = World("sharded", 4, {
        "trainer": {"dir": str(root), "ckpt0": str(ckpt0), "steps": STEPS,
                    "batch": BATCH, "seq": SEQ, "seed": SEED},
        "engine": dict(ENGINE, cfg=port.cfg, prompts=PROMPTS,
                       params=str(root / "serve_params.pt"))})
    shutil.copytree(ckpt0, root / "ref")
    ref_losses = _ref_trainer(root / "ref").run()["losses"]
    eng = RefServeEngine(ref, params, n_slots=ENGINE["n_slots"],
                         max_len=ENGINE["max_len"])
    for rid, p in enumerate(PROMPTS):
        eng.submit(RefRequest(rid=rid, prompt=p,
                              max_new_tokens=ENGINE["max_new"]))
    ref_out = {r.rid: [int(t) for t in r.out]
               for r in eng.run_until_drained()}
    return world.result(timeout=300), ref_losses, ref_out


# ------------------------------------------------------------- trainer

def test_trainer_state_is_sharded_over_the_data_ranks(world):
    o = world[0]["trainer"]
    assert o["table_placements"] == ["S(1)"]       # embed over data
    assert o["table_local_shape"] == (256, 16)     # 64 / 4 columns
    assert o["final_step"] == STEPS


def test_sharded_recovery_rolls_back_to_the_failure_through_memory(world):
    o = world[0]["trainer"]
    assert o["rollbacks"] == [o["fail_step"]]


def test_sharded_recovery_is_bitwise_identical(world):
    o = world[0]["trainer"]
    assert o["ft_digest"] == o["digest"]
    assert o["ft_losses"] == o["losses"]


def test_sharded_losses_match_reference(world):
    o, ref_losses, _ = world
    assert len(o["trainer"]["losses"]) == len(ref_losses) == STEPS
    np.testing.assert_allclose(o["trainer"]["losses"], ref_losses,
                               rtol=1e-5)


def test_sharded_save_writes_the_unsharded_bytes(world):
    o = world[0]["trainer"]
    assert "manifest.json" in o["frame_files"]
    assert o["frames_equal"]


# -------------------------------------------------------------- engine

def test_kv_cache_is_split_over_all_ranks(world):
    o = world[0]["engine"]
    assert o["k_mesh"] == (("data", "model"), 4)
    assert o["k_placements"] == ["S(1)", "S(2)"]    # lanes, kv_seq
    L, B, S, Hkv, hd = o["k_shape"]
    assert o["k_local_shape"] == (L, B // 2, S // 2, Hkv, hd)


def test_sharded_engine_is_deterministic(world):
    o = world[0]["engine"]
    assert o["out1"] == o["out2"] and len(o["out1"]) == len(PROMPTS)


def test_sharded_engine_matches_reference(world):
    o, _, ref_out = world
    assert o["engine"]["out1"] == ref_out
