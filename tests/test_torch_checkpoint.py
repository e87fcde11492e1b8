"""Checkpoint substrate of the port, held against the JAX package.

Frames and manifests must be byte-identical between the packages for the
same state, and each package must load (and verify) the other's
directories, full and delta-chained. The rest ports the reference's
FileCheckpointer unit tests to tensors.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import FileCheckpointer as RefCheckpointer
from repro.checkpoint.policy import TABLE2 as REF_TABLE2
from repro_torch.checkpoint import (CheckpointPolicy, FileCheckpointer,
                                    checkpoint_kind_for, flatten_state,
                                    serde, tree_digest, unflatten_state)
from repro_torch.checkpoint.manifest import Manifest, leaf_digest
from repro_torch.checkpoint.policy import TABLE2
from repro_torch.kernels.checksum.ref import TILE_BYTES
from repro_torch.scenarios import hooks
from _torch_threads import few_threads  # noqa: F401  (autouse)


def _np_state(seed=0, tiles=8):
    rng = np.random.default_rng(seed)
    n = tiles * TILE_BYTES // 4
    return {"params": {"w0": rng.standard_normal(n).astype(np.float32),
                       "w1": rng.standard_normal((n // 64, 64))
                       .astype(np.float32),
                       "h": rng.standard_normal(333).astype(np.float16)},
            "mask": rng.random(77) > 0.5,
            "ids": rng.integers(0, 9, 100).astype(np.int32),
            "step": np.array(3, np.int32)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _dirty(tree, frac=0.05, bump=1.0001, key="w0"):
    out = {**tree, "params": dict(tree["params"])}
    a = np.array(out["params"][key])
    a[:max(1, int(a.size * frac))] *= bump
    out["params"][key] = a
    return out


def _files(d, step):
    sd = os.path.join(d, f"step_{step:010d}")
    return {n: open(os.path.join(sd, n), "rb").read()
            for n in sorted(os.listdir(sd))}


def _assert_same_bytes(tree, loaded):
    flat, got = flatten_state(tree), flatten_state(loaded)
    assert sorted(flat) == sorted(got)
    for k in flat:
        assert np.asarray(got[k]).tobytes() == np.asarray(flat[k]).tobytes()


# ------------------------------------------------- across the packages

@pytest.mark.parametrize("n_shards", [1, 3])
def test_frames_and_manifest_byte_identical(tmp_path, n_shards):
    st = _np_state(1)
    ours = FileCheckpointer(str(tmp_path / "port"), n_shards=n_shards)
    ref = RefCheckpointer(str(tmp_path / "ref"), n_shards=n_shards)
    ours.save(5, _as_torch(st))
    ref.save(5, _as_jax(st))
    assert _files(str(tmp_path / "port"), 5) == \
        _files(str(tmp_path / "ref"), 5)


def _write_chain(ck, to_tree, states):
    for s, st in enumerate(states, start=1):
        ck.save(s, to_tree(st))
    ck.wait()


def _chain_states():
    st = _np_state(2)
    out = [st]
    for key in ("w0", "w1", "w0"):
        out.append(_dirty(out[-1], key=key))
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_delta_chain_loads_across_packages(tmp_path, writer):
    """A full frame plus a 3-link delta chain written by one package is
    loaded and verified, step by step, by the other; with the gather on,
    both write the same frames byte for byte."""
    states = _chain_states()
    kw = dict(keep=10, n_shards=2, delta_every=8, gather="on")
    ours = FileCheckpointer(str(tmp_path / "port"), **kw)
    ref = RefCheckpointer(str(tmp_path / "ref"), **kw)
    _write_chain(ours, _as_torch, states)
    _write_chain(ref, _as_jax, states)
    kinds = [ours._manifest(s).kind for s in ours.steps()]
    assert kinds == ["full", "delta", "delta", "delta"]
    for s in ours.steps():
        assert _files(str(tmp_path / "port"), s) == \
            _files(str(tmp_path / "ref"), s)
    src = str(tmp_path / writer)
    reader = (RefCheckpointer if writer == "port" else FileCheckpointer)(src)
    for s, st in enumerate(states, start=1):
        man, loaded = reader.load(s, verify=True)
        assert man.kind == ("full" if s == 1 else "delta")
        _assert_same_bytes(st, loaded)


def _flip_leaf_byte(shard_path: str, leaf: str, byte_in_leaf: int):
    """Flip one byte inside `leaf`'s data region of a serde frame."""
    with open(shard_path, "rb") as f:
        _, views = serde.from_bytes(f.read())
    hdr_offsets = serde._layout(views, None)[1]
    (off,) = [o for path, _, o in hdr_offsets if path == leaf]
    with open(shard_path, "r+b") as f:
        f.seek(off + byte_in_leaf)
        old = f.read(1)
        f.seek(off + byte_in_leaf)
        f.write(bytes([old[0] ^ 0xFF]))


def test_flipped_byte_raises_same_error(tmp_path):
    for name, cls, conv in (("port", FileCheckpointer, _as_torch),
                            ("ref", RefCheckpointer, _as_jax)):
        ck = cls(str(tmp_path / name))
        ck.save(7, conv({"w": np.arange(128, dtype=np.float32)}))
    msgs = []
    for name in ("port", "ref"):
        shard = str(tmp_path / name / "step_0000000007" / "shard_00000.bin")
        _flip_leaf_byte(shard, "w", 200)
    for reader, name in ((FileCheckpointer, "ref"), (RefCheckpointer, "port"),
                         (FileCheckpointer, "port")):
        with pytest.raises(OSError) as e:
            reader(str(tmp_path / name)).load(7)
        msgs.append(str(e.value))
    assert msgs == ["checkpoint step 7 corrupted: ['w']"] * 3


def test_table2_matches_reference():
    assert TABLE2 == REF_TABLE2


def test_bfloat16_leaf_roundtrips_as_tensor(tmp_path):
    t = torch.randn(1000).to(torch.bfloat16)
    ck = FileCheckpointer(str(tmp_path))
    ck.save(1, {"b": t})
    man = ck._manifest(1)
    assert man.leaves["b"]["dtype"] == "bfloat16"
    _, loaded = ck.load(1)
    assert loaded["b"].dtype == torch.bfloat16 and torch.equal(loaded["b"], t)
    ref = RefCheckpointer(str(tmp_path))
    _, rl = ref.load(1)                   # the reference reads it too
    assert rl["b"].tobytes() == t.view(torch.uint16).numpy().tobytes()


# ------------------------------------------- reference unit tests, ported

def test_file_roundtrip_and_gc(tmp_path):
    ck = FileCheckpointer(str(tmp_path), keep=2, n_shards=3)
    state = {"a": torch.arange(8.0), "nest": {"b": torch.ones((2, 3))},
             "lst": [torch.zeros(1), torch.ones(1)]}
    for step in [1, 2, 3, 4]:
        ck.save(step, state)
    assert ck.steps() == [3, 4]
    step, loaded = ck.load_latest()
    assert step == 4
    assert tree_digest(loaded) == tree_digest(state)
    assert isinstance(loaded["lst"], list)


def test_flatten_roundtrip():
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros((2, 2)),
                                      "d": [torch.arange(3)]}}
    assert tree_digest(unflatten_state(flatten_state(tree))) == \
        tree_digest(tree)


def test_npz_legacy_roundtrip_and_corruption(tmp_path):
    ck = FileCheckpointer(str(tmp_path), fmt="npz", n_shards=2)
    state = {"a": torch.arange(8.0), "nest": {"b": torch.ones((2, 3))}}
    ck.save(1, state)
    step, loaded = ck.load_latest()
    assert step == 1 and tree_digest(loaded) == tree_digest(state)
    shard = os.path.join(str(tmp_path), "step_0000000001", "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(200)
        f.write(b"\x00" * 64)
    with pytest.raises(Exception):
        ck.load(1)


def test_uncommitted_ignored_and_gc_spares_live_tmp(tmp_path):
    ck = FileCheckpointer(str(tmp_path))
    ck.save(3, {"w": torch.ones(4)})
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))
    assert ck.steps() == [3]
    live = tmp_path / f"tmp_0000000001_{os.getpid()}"
    live.mkdir()
    ck._live_tmps.add(live.name)
    stale = tmp_path / "tmp_0000000008_99999"
    stale.mkdir()
    ck._gc()
    assert live.exists() and not stale.exists()
    assert ck.load_latest()[0] == 3


def test_async_double_buffering(tmp_path):
    ck = FileCheckpointer(str(tmp_path), keep=4, n_shards=2)
    state = {"w": torch.arange(256.0),
             "s": torch.zeros((), dtype=torch.int32)}
    want = tree_digest(state)
    for step in [1, 2, 3, 4]:
        ck.save(step, state, async_=True)
    ck.wait()
    assert ck.steps() == [1, 2, 3, 4]
    for step in [1, 4]:
        assert tree_digest(ck.load(step)[1]) == want


def test_manifest_verify_and_policy():
    flat = {"x": np.arange(10, dtype=np.float32)}
    man = Manifest.build(1, flat, lambda k: 0, 1)
    assert man.verify(flat) == []
    assert man.verify({"x": torch.arange(10, dtype=torch.float32)}) == []
    assert man.verify({"x": flat["x"] + 1}) == ["x"]
    assert man.verify({}) == ["x"]
    assert checkpoint_kind_for("node", "reinit") == "file"
    p = CheckpointPolicy(every_steps=3)
    assert [s for s in range(1, 10) if p.should_checkpoint(s)] == [3, 6, 9]
    a = np.zeros((4,), np.float32)
    assert leaf_digest(a) != leaf_digest(a.astype(np.float64))
    assert leaf_digest(a) != leaf_digest(a.reshape(2, 2))


def test_sync_save_uses_device_digests(monkeypatch, tmp_path):
    """A save of tensors with the gather on digests through the tile
    path: if any leaf fell back to host hashing, this bombs."""
    import repro_torch.checkpoint.file_ckpt as fc

    def bomb(_):
        raise AssertionError("host leaf_digest called on device path")

    monkeypatch.setattr(fc, "leaf_digest", bomb)
    st = _np_state(3)
    ck = FileCheckpointer(str(tmp_path), delta_every=4, gather="on",
                          n_shards=2)
    ck.save(1, _as_torch(st))
    ck.save(2, _as_torch(_dirty(st)))
    assert ck.last_write["kind"] == "delta"
    ck.close()
    monkeypatch.undo()
    assert FileCheckpointer(str(tmp_path)).load_latest(verify=True)[0] == 2


def test_gather_e2e_bit_exact_and_d2h_proportional(tmp_path):
    """Mixed sync/async saves with the gather on: every step restores
    bit-exactly, and a sparse-dirty delta save moves <= 0.25x of the
    state across the device-to-host boundary."""
    ck = FileCheckpointer(str(tmp_path), keep=20, n_shards=2,
                          delta_every=8, gather="on")
    st = _np_state(5, tiles=16)
    hist = {}
    for s in range(1, 7):
        if s > 1:
            st = _dirty(st, key=f"w{s % 2}")
        ck.save(s, _as_torch(st), async_=(s % 2 == 0))
        hist[s] = st
    ck.wait()
    full = sum(np.asarray(v).nbytes for v in flatten_state(st).values())
    assert ck.last_write["kind"] == "delta"
    assert ck.last_write["d2h_bytes"] <= 0.25 * full
    for s in ck.steps():
        _assert_same_bytes(hist[s], ck.load(s, verify=True)[1])
    ck.close()


def test_npz_delta_every_forced_full(tmp_path):
    ck = FileCheckpointer(str(tmp_path), fmt="npz", delta_every=8)
    assert ck.delta_every == 0 and not ck._delta_on
    ck.save(1, _as_torch({"w": np.ones(10, np.float32)}))
    assert ck.last_write["kind"] == "full" and ck._chain.prev is None


def _rebase_chain(tmp_path, rebase_after):
    ck = FileCheckpointer(str(tmp_path), keep=20, n_shards=2,
                          delta_every=32, gather="on",
                          rebase_after=rebase_after)
    st, hist = _np_state(6), {}
    for s in range(1, 7):
        if s > 1:
            st = _dirty(st, key=f"w{s % 2}")
        ck.save(s, _as_torch(st))
        hist[s] = st
    return ck, hist


def test_rebase_compacts_chain_and_restores_bit_exact(tmp_path):
    ck, hist = _rebase_chain(tmp_path, rebase_after=3)
    ck.wait()
    assert ck.last_rebase.get("ok"), ck.last_rebase
    tip = ck.last_rebase["step"]
    assert ck._manifest(tip).kind == "full"
    for s in ck.steps():
        _assert_same_bytes(hist[s], ck.load(s, verify=True)[1])
    ck.close()


@pytest.mark.parametrize("point", ["ckpt.file.rebase.begin",
                                   "ckpt.file.rebase.pre_commit"])
def test_rebase_crash_at_hook_leaves_chain_authoritative(tmp_path, point):
    def injector(p, **ctx):
        if p == point:
            raise RuntimeError(f"injected at {p}")

    hooks.install(injector)
    try:
        ck, hist = _rebase_chain(tmp_path, rebase_after=3)
        ck.wait()
        assert ck.last_rebase.get("ok") is False
        tip = ck.last_rebase["step"]
        assert ck._manifest(tip).kind == "delta"
        for s in ck.steps():
            _assert_same_bytes(hist[s], ck.load(s, verify=True)[1])
    finally:
        hooks.clear()
    ck._rebase(tip)
    assert ck._manifest(tip).kind == "full"
    _assert_same_bytes(hist[tip], ck.load(tip, verify=True)[1])
    ck.close()


def test_reference_reads_port_rebased_chain(tmp_path):
    ck, hist = _rebase_chain(tmp_path, rebase_after=3)
    ck.wait()
    ck.close()
    ref = RefCheckpointer(str(tmp_path))
    for s in ref.steps():
        _assert_same_bytes(hist[s], ref.load(s, verify=True)[1])
    shutil.rmtree(str(tmp_path))


_CHILD = r"""
import os, signal, sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.checkpoint import FileCheckpointer
from repro_torch.scenarios import hooks

d, side = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(0)
state = {f"w{i}": torch.from_numpy(rng.standard_normal(8192)
                                   .astype(np.float32)) for i in range(3)}
ck = FileCheckpointer(d, keep=20, n_shards=2, delta_every=32, gather="on")
hist = {}
for s in range(1, 7):
    if s > 1:
        k = f"w{s % 3}"
        a = state[k].clone(); a[:100] *= 1.0001
        state[k] = a
    ck.save(s, state)
    hist[s] = {k: v.numpy().copy() for k, v in state.items()}
np.savez(side, **{f"{s}/{k}": v for s, fl in hist.items()
                  for k, v in fl.items()})

def die(p, **ctx):
    if p == "ckpt.file.rebase.pre_commit":
        os.kill(os.getpid(), signal.SIGKILL)

hooks.install(die)
ck._rebase(6)                 # staged frame fires the hook -> SIGKILL
"""


def test_rebase_sigkill_mid_stage_then_recover(tmp_path):
    """SIGKILL the process while the re-based frame is staged but not
    committed: a fresh process sees the old chain bit-exactly, and its
    own re-base of the same directory succeeds."""
    import signal
    import subprocess
    import sys
    d, side = str(tmp_path / "ckpt"), str(tmp_path / "expected.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    proc = subprocess.run([sys.executable, "-c", _CHILD, d, side],
                          env=env, capture_output=True, timeout=240)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()[-2000:]
    expected = dict(np.load(side).items())
    ck = FileCheckpointer(d, keep=20, n_shards=2, delta_every=32,
                          gather="on", rebase_after=3)
    assert ck.steps() == list(range(1, 7))
    for s in ck.steps():
        _, st_ = ck.load(s, verify=True)
        for k in st_:
            assert st_[k].tobytes() == expected[f"{s}/{k}"].tobytes()
    ck._rebase(6)
    assert ck._manifest(6).kind == "full"
    _, st_ = ck.load(6, verify=True)
    for k in st_:
        assert st_[k].tobytes() == expected[f"6/{k}"].tobytes()
    ck.close()
