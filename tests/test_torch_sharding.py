"""The port's sharding rules, partitioning and mesh, against the
reference's tables, and on a 4-rank gloo world on the CPU: the buddy
ring of shards, the shard order of a split over two axes, the constraint
scope, F1's and S1's calls on each rank's shards, and whole prefills
under a (data, model) mesh against the same model unsharded.

The world is spawned once for the module (`_torch_mesh_worlds.spawn`,
one deadline of 300 s) and every case reads its results."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.model import Model as RefModel
from repro.sharding import partition as ref_partition
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models.model import Model
from repro_torch.sharding import partition, rules
from repro_torch.sharding.rules import P
from repro_torch.tree import tree_leaves
from _torch_mesh_worlds import spawn
from _torch_threads import few_threads  # noqa: F401  (autouse)

PRESETS = sorted(rules.PRESETS)
PREFILL_ARCHS = ["qwen2-7b", "falcon-mamba-7b", "olmoe-1b-7b", "zamba2-7b",
                 "qwen2-7b+sp"]


# ------------------------------------------------------------- the tables

def _ref_flat(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, RefP))
    return {ref_rules._path_str(p): tuple(s) for p, s in flat}


def _flat(tree, specs) -> dict:
    return {p: tuple(s) for p, s in zip(tree_leaves(rules.tree_paths(tree)),
                                        tree_leaves(specs))}


@pytest.fixture(scope="module")
def trees():
    """Per arch: (reference state of ShapeDtypeStructs, port state of
    tensors), each {"params", "opt": {"m", "v", "count"}, "step"}."""
    out = {}
    for arch in ARCHS:
        rp = jax.eval_shape(lambda a=arch: RefModel(ref_reduced(
            ref_get_config(a))).init(jax.random.PRNGKey(0)))
        scalar = jax.ShapeDtypeStruct((), jnp.int32)
        p = Model(reduced(get_config(arch))).init(
            torch.Generator().manual_seed(0))
        z = torch.zeros((), dtype=torch.int32)
        out[arch] = ({"params": rp, "opt": {"m": rp, "v": rp,
                                            "count": scalar},
                      "step": scalar},
                     {"params": p, "opt": {"m": p, "v": p, "count": z},
                      "step": z})
    return out


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference(trees, arch, preset):
    """Every leaf of the train state and of the decode state gets the
    reference's spec, by the same path."""
    ref_state, state = trees[arch]
    want = _ref_flat(ref_rules.tree_specs(ref_state,
                                          ref_rules.PRESETS[preset]))
    got = _flat(state, rules.tree_specs(state, rules.PRESETS[preset]))
    assert got == want
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    want = _ref_flat(RefModel(ref_reduced(ref_get_config(arch)))
                     .decode_state_specs(ref_rules.PRESETS[preset]))
    meta = model.init_decode_state(2, 8, device="meta")
    got = _flat(meta, model.decode_state_specs(rules.PRESETS[preset]))
    assert got == want


@pytest.mark.parametrize("path,rank,want", [
    ("embedding/table", 2, ("model", "data")),
    ("stack/layers/attn/wq", 3, (None, "data", "model")),
    ("stack/layers/mlp/wo", 3, (None, "model", "data")),
    ("stack/layers/moe/wi_gate", 4, (None, "model", "data", None)),
    ("stack/layers/ln1/scale", 2, (None, None)),
    ("stack/layers/mamba/in_x", 3, (None, "data", "model")),
    ("stack/layers/mamba/in_bc", 3, (None, "data", None)),
    ("stack/layers/attn/wk", 3, (None, "data", None)),
    ("stack/layers/mamba/A_log", 3, ()),
    ("stack/layers/mamba/in_x", 4, (None, None, "data", "model")),
    ("no/such/leaf", 2, ()),
])
def test_spec_for_path_cases(path, rank, want):
    """The reference's own cases (and a grouped, an unsharded and an
    unmatched leaf): same spec as the reference and as written there."""
    pod, ref_pod = rules.PRESETS["pod"], ref_rules.PRESETS["pod"]
    got = rules.spec_for_path(path, rank, pod)
    assert got == want
    assert tuple(got) == tuple(ref_rules.spec_for_path(path, rank, ref_pod))


@pytest.mark.parametrize("spec,shape", [
    (("model",), (7,)), (("data", "model"), (8, 6)),
    (("data", "model"), (6, 28)), ((None, "model", None), (3, 56, 4)),
    ((("pod", "data"), None), (8, 3)), ((("pod", "data"),), (6,)),
    (("model",), (16, 5)), ((), (4, 4)),
])
def test_divisible_equals_reference(spec, shape):
    """Axes that do not divide their dim are dropped as the reference
    drops them (56 heads on a 16-way model axis replicate)."""
    sizes = {"pod": 2, "data": 4, "model": 16}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    want = ref_partition._divisible(RefP(*spec), shape,
                                    types.SimpleNamespace(shape=sizes))
    assert tuple(partition._divisible(P(*spec), shape, mesh)) == tuple(want)


def test_partition_spec_is_the_reference_value():
    for parts in [(), ("a",), ("a", None), (("pod", "data"), None, "m")]:
        assert tuple(P(*parts)) == tuple(RefP(*parts))
        assert (P(*parts) == parts) == (RefP(*parts) == parts)
    assert P("a", None) != P("a") and RefP("a", None) != RefP("a")
    assert P(None) != P() and RefP(None) != RefP()
    assert hash(P("a", None)) == hash(P("a", None))
    assert rules.PRESETS["pod"].spec("batch", "heads", None) == \
        ("data", "model", None)


def test_shard_constraint_noop_outside_scope():
    x = torch.ones(4, 4)
    assert partition.shard_constraint(x, "batch", None) is x


def test_batch_spec():
    for name in PRESETS:
        r = rules.PRESETS[name]
        assert tuple(partition.batch_spec(r)) == tuple(
            ref_partition.batch_spec(ref_rules.PRESETS[name]))
        assert tuple(partition.batch_spec(r, seq_axis=True)) == tuple(
            ref_partition.batch_spec(ref_rules.PRESETS[name],
                                     seq_axis=True))


# ------------------------------------------------------- a world of one

@pytest.fixture(scope="module")
def world1():
    """A gloo group of one in this process, ended by the finaliser."""
    from repro_torch.launch.mesh import process_group
    with process_group(device="cpu"):
        yield


def test_meshes_need_the_whole_world(world1):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
        make_host_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        make_production_mesh(multi_pod=True, device="cpu")
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")


def test_placements_on_a_mesh(world1):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cpu")
    assert partition.placements(P("model", None, "data"), mesh) == \
        (Shard(2), Shard(0))
    assert partition.placements(P(), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="another order"):
        partition.placements(P(("model", "data")), mesh)
    # on a mesh of one a leaf keeps its storage
    t = torch.arange(6.0).reshape(2, 3)
    d = partition.distribute(t, partition.named(mesh, P("data", "model")))
    assert d.to_local().data_ptr() == t.data_ptr()
    assert torch.equal(partition.gather(d), t)


def test_kernel_wrappers_refuse_dtensors(world1):
    from repro_torch.kernels.checksum import ops as cks
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((1,), ("data",), device="cpu")
    d = partition.distribute(torch.ones(4, 8), partition.named(mesh, P()))
    for call in (lambda: cks.checksum_words_device(d),
                 lambda: cks.tile_checksums_device(d),
                 lambda: fa.flash_attention_kernel(d, d, d, causal=True),
                 lambda: ms.selective_scan_kernel(d, d, d, d, d)):
        with pytest.raises(TypeError, match="plain tensors"):
            call()


# ------------------------------------------------------- the 4-rank world

@pytest.fixture(scope="module")
def world():
    return spawn("sharding", 4, {"prefill": PREFILL_ARCHS}, timeout=300)


@pytest.mark.parametrize("case", ["vocab", "vocab_embed"])
def test_buddy_exchange_is_a_roll_by_one_shard(world, case):
    """A leaf sharded over 4 data ranks comes back rolled by one shard
    (4 rows of 16, or 2 of the 8 embed columns), and the restore inverts
    it bit for bit; the replicated leaf comes back as it went."""
    o, s = world[case], world["state"]
    buddy, back = o["table"]
    assert np.array_equal(buddy, np.roll(s["table"], 4, axis=0))
    assert np.array_equal(back, s["table"])
    buddy, back = o["wo"]
    want = np.roll(s["wo"], 2, axis=2) if case == "vocab_embed" \
        else s["wo"]
    assert o["placements"] == (["S(2)"] if case == "vocab_embed" else ["R"])
    assert np.array_equal(buddy, want) and np.array_equal(back, s["wo"])
    buddy, back = o["scale"]
    assert o["scale_same_object"]
    assert np.array_equal(buddy, s["scale"])
    assert np.array_equal(back, s["scale"])


def test_buddy_exchange_refuses_an_undistributed_state(world):
    assert "plain tensor" in world["plain_raises"]


def test_multipod_split_is_major_to_minor(world):
    """batch=("pod", "data") on a (pod, data) mesh: rank (p, d) holds
    rows chunk p*2+d, as a JAX mesh splits them; the ring along data
    moves each pod's shards within the pod."""
    o = world["multipod"]
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    p, d = o["coord"]
    c = p * 2 + d
    assert o["placements"] == ["S(0)", "S(0)"]
    assert o["offsets"] == (2 * c, 0)
    assert np.array_equal(o["local"], x[2 * c:2 * c + 2])
    chunks = x.reshape(4, 2, 3)
    want = np.concatenate([chunks[1], chunks[0], chunks[3], chunks[2]])
    assert np.array_equal(o["buddy"], want)


def test_constraint_scope(world):
    o = world["scope"]
    assert o["outside_is_identity"]
    assert o["placements"] == ["S(0)", "S(2)"] and o["value_kept"]
    assert o["odd_placements"] == ["R", "R"]       # 3 lanes, 5 heads
    assert "never distributed" in o["plain_raises"]


@pytest.mark.parametrize("case", ["whole", "cut"])
def test_flash_attention_on_each_ranks_heads(world, case):
    """F1's wrapper (its plain version here) on each rank's lanes and
    heads equals attention on the whole, exactly: with the GQA groups
    whole on a rank and cut across ranks."""
    o = world["flash"][case]
    assert o["max_abs_err"] == 0.0
    assert o["placements"] == ["S(0)", "S(2)"]


def test_scan_on_each_ranks_lanes_and_channels(world):
    o = world["scan"]
    assert o["y_err"] == 0.0 and o["h_err"] == 0.0
    assert o["placements"] == [["S(0)", "S(2)"], ["S(0)", "S(1)"]]


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_under_a_mesh(world, arch):
    """A whole prefill (float32, pallas route) under a (2, 2) pod_serve
    mesh equals the unsharded one within 1e-5 of the logits' largest:
    the model-axis products sum their shards in another order. "+sp":
    with `ExecConfig.seq_parallel` and seq over the model axis."""
    assert world["prefill"][arch] <= 1e-5
