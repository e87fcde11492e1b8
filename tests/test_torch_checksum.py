"""Checksum kernels of the port: plain torch versions of K1/K2/K3 against
the JAX package's Pallas kernels (interpret mode) and numpy oracle.

Equality is exact (bit for bit): the digests are integer arithmetic mod
2^32, and each package must verify the other's checkpoints. The CUDA
kernels themselves are held against these plain versions on the card
(`gpu` tests below, and `chip_smoke.py`).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manifest import leaf_digest as ref_leaf_digest
from repro.kernels.checksum.kernel import (checksum_kernel,
                                           gather_tiles_kernel,
                                           tile_checksum_kernel)
from repro.kernels.checksum.ops import _device_tiles2d, _device_words
from repro.kernels.checksum.ref import (TILE_WORDS, checksum_words_ref,
                                        gather_tiles_ref, n_tiles,
                                        tile_checksums_ref)
from repro_torch.checkpoint.manifest import leaf_digest
from repro_torch.kernels.checksum import ops
from _torch_threads import few_threads  # noqa: F401  (autouse)

BF16 = np.dtype(ml_dtypes.bfloat16)


def _case(name):
    rng = np.random.default_rng(11)
    return {
        "f32_partial": rng.standard_normal(3 * TILE_WORDS + 7)
        .astype(np.float32),
        "f32_2d": rng.standard_normal((33, 70)).astype(np.float32),
        "bf16_odd": rng.standard_normal(1025).astype(BF16),
        "f16_odd": rng.standard_normal(2 * TILE_WORDS + 1)
        .astype(np.float16),
        "u8_tail": rng.integers(0, 255, 4099).astype(np.uint8),
        "i64": rng.integers(-2**40, 2**40, 700).astype(np.int64),
        "bool": rng.random(65) > 0.5,
        "scalar": np.array(1.5, np.float32),
        "exact_tiles": rng.standard_normal(2 * TILE_WORDS)
        .astype(np.float32),
    }[name]


CASES = ["f32_partial", "f32_2d", "bf16_odd", "f16_odd", "u8_tail", "i64",
         "bool", "scalar", "exact_tiles"]


def _jax_words(a: np.ndarray):
    """The reference's device word stream of `a`, or None where jax (64-bit
    types off) would not hold `a` at its own dtype (int64 becomes int32)."""
    j = jnp.asarray(a)
    return _device_words(j) if j.dtype == a.dtype else None


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("name", CASES)
def test_tile_digests_match_pallas_and_ref(name):
    """K1's plain version == Pallas tile_checksum_kernel (interpret) ==
    numpy tile_checksums_ref."""
    a = _case(name)
    port = ops.tile_checksums(_tensor(a))
    assert port.dtype == np.uint32
    assert np.array_equal(port, tile_checksums_ref(a))
    words = _jax_words(a)
    if words is not None:
        pallas = np.asarray(tile_checksum_kernel(words, interpret=True))
        assert np.array_equal(port, pallas)


@pytest.mark.parametrize("name", CASES)
def test_leaf_digest_matches_pallas_and_ref(name):
    """K2's plain version == Pallas checksum_kernel (interpret) == numpy
    checksum_words_ref, and the manifest digest strings agree."""
    a = _case(name)
    port = ops.checksum_words(_tensor(a))
    assert port == checksum_words_ref(a)
    words = _jax_words(a)
    if words is not None:
        s0, s1 = checksum_kernel(words, interpret=True)
        assert port == (int(s0), int(s1))
    assert leaf_digest(_tensor(a)) == ref_leaf_digest(a) == leaf_digest(a)


@pytest.mark.parametrize("name", ["f32_partial", "f16_odd", "u8_tail",
                                  "exact_tiles", "bf16_odd"])
def test_gather_matches_pallas_and_ref(name):
    """K3's plain version == Pallas gather_tiles_kernel (interpret) ==
    numpy gather_tiles_ref, trailing partial tile zero-padded."""
    a = _case(name)
    nt = n_tiles(a.nbytes)
    idx = np.arange(nt - 1, -1, -2)[::-1].astype(np.int32)  # ascending
    port = ops.gather_tiles_device(_tensor(a), idx).numpy().view(np.uint32)
    pallas = np.asarray(gather_tiles_kernel(
        _device_tiles2d(jnp.asarray(a)).reshape(-1, 128), jnp.asarray(idx),
        interpret=True))
    assert np.array_equal(port, gather_tiles_ref(a, idx))
    assert np.array_equal(port, pallas)


def test_empty_leaves():
    for a in (np.zeros((0,), np.float32), np.zeros((0, 3), np.int64)):
        t = _tensor(a)
        assert ops.checksum_words(t) == checksum_words_ref(a) == (0, 0)
        assert ops.tile_checksums(t).shape == (0, 3)
        assert ops.tile_checksums_device(t) is None
        assert leaf_digest(t) == ref_leaf_digest(a)


def test_non_contiguous_tensor_digests_its_values():
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    t = torch.from_numpy(a).T                  # a strided view
    assert ops.checksum_words(t) == checksum_words_ref(a.T)
    assert np.array_equal(ops.tile_checksums(t), tile_checksums_ref(a.T))


def test_cpu_tensors_never_count_launches():
    ops.reset_launches()
    t = torch.arange(5000, dtype=torch.float32)
    ops.checksum_words(t)
    ops.tile_checksums(t)
    ops.gather_tiles_device(t, [0])
    assert ops.LAUNCHES == {"tile_checksums": 0, "checksum_words": 0,
                            "gather_tiles": 0}


def test_gather_rejects_out_of_range_tiles():
    with pytest.raises(IndexError):
        ops.gather_tiles_device(torch.zeros(10), [1])


@pytest.mark.parametrize("kernel", [ops.tile_checksums_kernel,
                                    ops.checksum_words_kernel])
def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(kernel):
    """Checked before the library is built or anything is launched: a CPU
    stream, a non-uint8 tensor, an empty stream."""
    for bad in (torch.zeros(64, dtype=torch.uint8),
                torch.zeros(16, dtype=torch.float32),
                torch.zeros(0, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="checksum kernels take"):
            kernel(bad)


@pytest.mark.parametrize("seed,scale,tiles,aliased", [
    (9206, 0.5, 1, 0),      # the scaled tile 0 keeps all three columns
    (9205, 0.5, 2, 1),      # tile 1 of the two scaled tiles aliases
])
def test_c1_uniform_scaling_aliasing_is_reproduced(seed, scale, tiles,
                                                   aliased):
    """ROADMAP C1: for these seeds a power-of-two scaling leaves a tile's
    (s0, s1, m) row unchanged. The port must reproduce the reference's
    digests bit for bit, aliasing included."""
    rng = np.random.default_rng(seed)
    a = (1.0 + rng.random(4 * TILE_WORDS, np.float32) * 0.5) \
        .astype(np.float32)
    b = a.copy()
    b[:tiles * TILE_WORDS] *= np.float32(scale)
    ra, rb = ops.tile_checksums(_tensor(a)), ops.tile_checksums(_tensor(b))
    assert np.array_equal(ra, tile_checksums_ref(a))
    assert np.array_equal(rb, tile_checksums_ref(b))
    assert np.array_equal(ra[aliased], rb[aliased])
    assert not np.array_equal(a[:tiles * TILE_WORDS],
                              b[:tiles * TILE_WORDS])


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernels_match_plain_versions(cuda, name):
    a = _case(name)
    b = ops.byte_stream(_tensor(a).to(cuda))
    assert torch.equal(ops.tile_checksums_kernel(b),
                       ops.tile_checksums_plain(b))
    assert torch.equal(ops.checksum_words_kernel(b),
                       ops.checksum_words_plain(b))
    nt = n_tiles(a.nbytes)
    idx = torch.arange(0, nt, 2, dtype=torch.int32, device=cuda)
    assert torch.equal(ops.gather_tiles_kernel(b, idx),
                       ops.gather_tiles_plain(b, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k 1", "k not a multiple of 8",
                                  "partial last tile", "more than a wave"])
def test_k3_gathers_like_its_plain_version(cuda, case):
    """K3's edges: one tile, a last pass of fewer than 8 tiles, the
    zero-padded trailing tile, and more tiles than one wave of blocks
    takes (blocks stride over the index list)."""
    rng = np.random.default_rng(5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nbytes, idx = {
        "k 1": (10 * 4096, [7]),
        "k not a multiple of 8": (40 * 4096,
                                  sorted(rng.choice(40, 13, replace=False))),
        "partial last tile": (5 * 4096 + 1001, [0, 3, 5]),
        "more than a wave": ((sms * 64 + 9) * 4096 + 12,
                             list(range(0, sms * 64 + 10))),
    }[case]
    x = torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8))
    x = x.to(cuda)
    n = ops.LAUNCHES["gather_tiles"]
    got = ops.gather_tiles_device(x, idx)
    assert ops.LAUNCHES["gather_tiles"] == n + 1
    b = ops.byte_stream(x)
    want = ops.gather_tiles_plain(b, torch.tensor(idx, dtype=torch.int32,
                                                   device=cuda))
    assert got.shape == (len(idx), TILE_WORDS) and torch.equal(got, want)
