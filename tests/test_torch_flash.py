"""Flash attention of the port (kernel F1's plain version on the CPU)
against the JAX package's Pallas kernel A4 in interpret mode and its
oracle, on the same numpy inputs.

Tolerances are the reference's own (`tests/test_kernels.py`): 2e-5 in
float32 (sums run in another order), 2e-2 in bfloat16 (one rounding of
the output). On the card, F1 is held to the plain version with the same
tolerances (the `gpu` tests below, and `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from _torch_threads import few_threads  # noqa: F401  (autouse)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, Sq, Sk, H, Hkv, hd, dtype):
    """(numpy float32 q, k, v) rounded to `dtype`, as jnp and torch."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]
    js = [jnp.asarray(a, _JNP[dtype]) for a in arrs]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(getattr(torch,
                                                                 dtype))
          for j in js]
    return js, ts


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (2, 128, 128, 4, 4, 64),        # MHA
    (1, 256, 256, 8, 2, 64),        # GQA 4:1
    (2, 128, 256, 4, 1, 128),       # MQA, longer KV (decode-suffix case)
    (1, 128, 128, 4, 4, 128),
    (1, 512, 512, 2, 2, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(B, Sq, Sk, H, Hkv, hd, causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Sk + H, B, Sq, Sk, H, Hkv, hd,
                                      dtype)
    want = ref_flash(jq, jk, jv, causal=causal, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = _TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (1, 77, 77, 4, 2, 16),          # a length no tile divides
    (2, 33, 100, 4, 1, 64),         # query suffix of a ragged KV prefix
    (1, 5, 3, 2, 2, 16),            # more queries than keys
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_oracle_at_odd_lengths(B, Sq, Sk, H, Hkv, hd, causal):
    (jq, jk, jv), (q, k, v) = _inputs(7, B, Sq, Sk, H, Hkv, hd, "float32")
    want = ref_oracle(jq, jk, jv, causal=causal)
    got = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_backward_raises():
    """The reference defines no VJP for A4: the port's op must not let
    attention silently drop out of a gradient."""
    _, (q, k, v) = _inputs(0, 1, 8, 8, 2, 2, 16, "float32")
    q.requires_grad_()
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.requires_grad
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


def test_plain_route_does_not_count_launches():
    ops.reset_launches()
    _, (q, k, v) = _inputs(0, 1, 8, 8, 2, 2, 16, "float32")
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == {"flash_attention": 0}


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (4, 512, 512, 12, 12, 64), (2, 128, 640, 28, 4, 128),
    (1, 77, 77, 4, 2, 16), (1, 200, 100, 4, 4, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f1_matches_plain_version(cuda, B, Sq, Sk, H, Hkv, hd, causal,
                                  dtype):
    _, (q, k, v) = _inputs(1, B, Sq, Sk, H, Hkv, hd, dtype)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    n = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == n + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    tol = _TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
def test_f1_rows_do_not_depend_on_the_batch(cuda):
    _, (q, k, v) = _inputs(2, 4, 77, 77, 28, 4, 128, "bfloat16")
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    whole = ops.flash_attention(q, k, v, causal=True)
    for b in range(4):
        alone = ops.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    causal=True)
        assert torch.equal(whole[b:b + 1], alone)
