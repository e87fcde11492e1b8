"""Where `ServeReplicator.publish` digests a serving rank's state: on the
snapshot's clones where they live (K1 on the card), or, for a DTensor
leaf, on its host copy in numpy. Either way the frames, kinds and tile
rows are those of a publisher given the host copy's numpy digests, and
the snapshot's clones are freed when the publish returns.

The `gpu` case serves on the card and skips without one; this file
imports no JAX, so that it runs there."""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import is_dtensor
from repro_torch.kernels.checksum import ops
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models.model import Model
from repro_torch.models.transformer import ExecConfig
from repro_torch.serve import Request, ServeEngine, ServeReplicator
from repro_torch.sharding.rules import PRESETS
from repro_torch.tree import tree_leaves
from _torch_publish import (Recorder, assert_same_publishes, publish_both,
                            ref_rows)
from _torch_threads import few_threads  # noqa: F401  (autouse)

STEPS = 5


def _engine(arch, device, **kw):
    cfg = reduced(get_config(arch))
    model = Model(cfg, ExecConfig(attn_impl="pallas"))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    # a table at scale 1.0, tied to the unembedding, makes greedy decode
    # repeat the last prompt token
    params["embedding"]["table"].mul_(0.05)
    eng = ServeEngine(model, params, n_slots=2, max_len=256, **kw)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=[8, 9, rid + 1],
                           max_new_tokens=6))
    return eng


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kinds", [
    ("qwen2-7b", {"full", "delta"}),
    # a decode step rewrites every active slot's SSM state: full frames
    ("falcon-mamba-7b", {"full"})])
def test_publish_digests_on_the_card(cuda, arch, kinds):
    """K1 digests every leaf of every publish on the card; its rows are
    the numpy reference's on the host copy, bit for bit, and the frames
    are the host-digest path's."""
    eng = _engine(arch, cuda)
    leaves = [v for v in tree_leaves(eng.state) if v.numel()]
    assert all(v.is_cuda and not is_dtensor(v) for v in leaves)
    before = ops.LAUNCHES["tile_checksums"]
    out = publish_both(eng, STEPS)
    assert ops.LAUNCHES["tile_checksums"] - before == STEPS * len(leaves)
    assert set(out.rep_kinds) == kinds
    assert_same_publishes(out)
    for tiles, flat in zip(out.rep_tiles, out.flats):
        for k, v in flat.items():
            assert np.array_equal(tiles[k].rows, ref_rows(v)), k
    c = out.rep_counters
    assert c["replicate.bytes_digested_device"] == \
        c["replicate.bytes_digested"] > 0


def test_dtensor_leaves_are_digested_on_their_host_copy():
    """A sharded engine's DTensor leaves take numpy on their host copy
    (world-1 mesh on the CPU): none of their bytes count as digested on
    the device, and the frames are the host-digest path's."""
    with process_group(device="cpu"):
        mesh = make_host_mesh((1, 1), ("data", "model"), device="cpu")
        eng = _engine("qwen2-7b", "cpu", mesh=mesh,
                      rules=PRESETS["pod_serve"])
        assert all(is_dtensor(v) for v in tree_leaves(eng.state))
        out = publish_both(eng, STEPS)
    assert set(out.rep_kinds) == {"full", "delta"}
    assert_same_publishes(out)
    assert out.rep_counters.get("replicate.bytes_digested_device", 0) == 0


def test_publish_frees_the_snapshot_when_it_returns():
    """The snapshot's clones die when `publish` returns, with the cycle
    collector off: on the card they are a rank's whole state, and clones
    held by a reference cycle until the collector's next pass would raise
    the memory peak by a state a publish."""
    eng = _engine("falcon-mamba-7b", "cpu")
    rep = ServeReplicator(Recorder(), base_every=3)
    clones = []
    snapshot = eng.snapshot

    def watched():
        snap = snapshot()
        clones.extend(weakref.ref(a.dev) for a in tree_leaves(snap["state"]))
        return snap

    eng.snapshot = watched
    was = gc.isenabled()
    gc.disable()
    try:
        for _ in range(3):
            eng.step()
            rep.publish(eng)
        assert clones and all(c() is None for c in clones)
    finally:
        if was:
            gc.enable()
