"""The port's two cross-entropy helpers of `models/layers.py` against the
JAX package's: `cross_entropy` (with and without a mask) and
`chunked_unembed_xent` (S a multiple of `n_chunks`, and not: the
fallback through the full logits). The same numpy inputs, drawn from a
seed, go through both. Tolerances: float32 within 1e-6 relative (the
sums run in another order, nothing else differs); a bfloat16
`compute_dtype` within 1e-2 relative (the frameworks round the products
to bf16 at different points)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_unembed_xent as ref_chunked
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro_torch.models.layers import (chunked_unembed_xent, cross_entropy,
                                       unembed)
from repro_torch.models.model import masked_chunked_xent
from _torch_threads import few_threads  # noqa: F401  (autouse)

B, V, D = 2, 64, 24
F32_RTOL = 1e-6
BF16_RTOL = 1e-2


def _inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32) * 0.5
    table = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    return x, table, labels


def _masks(S):
    rng = np.random.default_rng(7)
    return {
        "none": None,
        "bool": rng.random((B, S)) < 0.6,
        "float": (rng.random((B, S)) < 0.5).astype(np.float32),
        "empty": np.zeros((B, S), dtype=bool),
    }


@pytest.mark.parametrize("mask_kind", ["none", "bool", "float", "empty"])
def test_cross_entropy_matches_reference(mask_kind):
    S = 12
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, S, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, size=(B, S)).astype(np.int32)
    mask = _masks(S)[mask_kind]
    want = ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_RTOL)
    if mask_kind == "empty":              # the masked mean over max(0, 1)
        assert got.item() == 0.0


def test_cross_entropy_bf16_logits_accumulate_in_fp32():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((B, 10, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, 10)).astype(np.int32)
    want = ref_cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                             jnp.asarray(labels))
    got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                        torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_RTOL)


@pytest.mark.parametrize("S,n_chunks", [(16, 4), (18, 4), (16, 1),
                                        (12, 3)],
                         ids=["chunked", "fallback", "one-chunk",
                              "three-chunks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_unembed_xent_matches_reference(S, n_chunks, dtype):
    x, table, labels = _inputs(S)
    want = ref_chunked({"table": jnp.asarray(table)}, jnp.asarray(x),
                       jnp.asarray(labels), getattr(jnp, dtype),
                       n_chunks=n_chunks)
    got = chunked_unembed_xent({"table": torch.from_numpy(table)},
                               torch.from_numpy(x), torch.from_numpy(labels),
                               getattr(torch, dtype), n_chunks=n_chunks)
    assert got.dtype == torch.float32 and got.shape == ()
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol)


def test_chunked_equals_full_logits_and_masked_chunked():
    """The port's three routes to the same loss agree: the chunked loop,
    the full logits through `cross_entropy`, and the trainer's
    `masked_chunked_xent` with every label valid."""
    x, table, labels = _inputs(16, seed=2)
    emb = {"table": torch.from_numpy(table)}
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    chunked = chunked_unembed_xent(emb, xt, lt, torch.float32)
    full = cross_entropy(unembed(emb, xt, torch.float32), lt)
    masked = masked_chunked_xent(emb["table"], xt, lt, torch.float32)
    np.testing.assert_allclose(chunked.item(), full.item(), rtol=F32_RTOL)
    np.testing.assert_allclose(chunked.item(), masked.item(), rtol=F32_RTOL)
