"""The selective scan of the port (kernel S1's plain version on the CPU)
against the JAX package's Pallas kernel A5 in interpret mode and its
oracle, on the same numpy inputs.

Tolerance: the reference's own for A5 (`tests/test_kernels.py`), atol and
rtol 1e-4 in float32 (the recurrence's sums run in another order). On the
card, S1 is held to the plain version at the same tolerance (the `gpu`
tests below, and `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.kernel import selective_scan as ref_kernel
from repro.kernels.mamba_scan.ref import selective_scan_ref as ref_oracle
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from _torch_threads import few_threads  # noqa: F401  (autouse)

TOL = 1e-4


def _inputs(seed, b, S, di, ds):
    """numpy float32 (x, dt, B, C, A) drawn as the reference's tests draw
    them: dt > 0 and A < 0, so the state decays."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (n(b, S, di) * 0.5, np.abs(n(b, S, di)) * 0.1, n(b, S, ds),
            n(b, S, ds), -np.abs(n(di, ds)) - 0.1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("b,S,di,ds,chunk,block_d", [
    (2, 64, 32, 8, 32, 32),
    (2, 128, 64, 16, 64, 128),
    (1, 128, 256, 32, 32, 128),
])
def test_plain_matches_pallas_kernel(b, S, di, ds, chunk, block_d):
    arrs = _inputs(S + di + ds, b, S, di, ds)
    want_y, want_h = ref_kernel(*map(jnp.asarray, arrs), chunk=chunk,
                                block_d=block_d, interpret=True)
    y, h = ops.mamba_scan(*map(torch.from_numpy, arrs))
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, S, di)
    assert h.dtype == torch.float32 and tuple(h.shape) == (b, di, ds)
    _close(y, want_y)
    _close(h, want_h)


@pytest.mark.parametrize("b,S,di,ds", [
    (1, 1, 16, 8),              # one step
    (2, 3, 5, 16),              # shorter than any block, di no block divides
    (1, 130, 40, 16),           # a length no chunk divides
])
def test_plain_matches_oracle_at_odd_shapes(b, S, di, ds):
    arrs = _inputs(S * di, b, S, di, ds)
    want_y, want_h = ref_oracle(*map(jnp.asarray, arrs))
    y, h = ops.mamba_scan(*map(torch.from_numpy, arrs))
    _close(y, want_y)
    _close(h, want_h)


def test_h0_continuation_matches_oracle():
    """Two halves scanned with the carried state equal one full scan, in
    both packages' plain versions."""
    b, S, di, ds = 1, 128, 32, 8
    arrs = _inputs(5, b, S, di, ds)
    ts = [torch.from_numpy(a) for a in arrs]
    half = S // 2
    first = [t[:, :half] for t in ts[:4]] + [ts[4]]
    second = [t[:, half:] for t in ts[:4]] + [ts[4]]
    y1, h1 = selective_scan_ref(*first)
    y2, h2 = selective_scan_ref(*second, h0=h1)
    y_full, h_full = selective_scan_ref(*ts)
    torch.testing.assert_close(h2, h_full, atol=1e-5, rtol=0)
    torch.testing.assert_close(y2, y_full[:, half:], atol=1e-5, rtol=0)
    js = [jnp.asarray(a) for a in arrs]
    _, jh1 = ref_oracle(*[a[:, :half] for a in js[:4]], js[4])
    jy2, jh2 = ref_oracle(*[a[:, half:] for a in js[:4]], js[4], h0=jh1)
    _close(y2, jy2)
    _close(h2, jh2)


def test_cpu_route_launches_nothing():
    n = ops.LAUNCHES["selective_scan"]
    ops.mamba_scan(*map(torch.from_numpy, _inputs(0, 1, 8, 8, 8)))
    assert ops.LAUNCHES["selective_scan"] == n


def test_backward_raises():
    """The reference defines no VJP for A5: the port's op must not let the
    scan silently drop out of a gradient."""
    x, dt, B, C, A = map(torch.from_numpy, _inputs(0, 1, 8, 8, 8))
    x.requires_grad_()
    y, _ = ops.mamba_scan(x, dt, B, C, A)
    with pytest.raises(NotImplementedError, match="forward-only"):
        y.sum().backward()


def test_bad_shapes_raise():
    x, dt, B, C, A = map(torch.from_numpy, _inputs(0, 1, 8, 8, 8))
    with pytest.raises(ValueError, match="bad shapes"):
        ops.mamba_scan(x, dt, B, C, A[:4])
    with pytest.raises(ValueError, match="bad shapes"):
        ops.mamba_scan(x, dt[:, :4], B, C, A)


# ------------------------------- S1's order of operations, on the CPU

def _fma(a, b, c):
    """float32 a * b + c rounded once, as the card's FFMA (through float64,
    whose 53 bits hold the product exactly; the sum rounds twice, which
    differs from one rounding only at ties)."""
    return (a.double() * b.double() + c.double()).float()


def _emulate_s1(x, dt, B, C, A):
    """S1's arithmetic in plain torch: per state dA = exp(dt * A) and
    h = fma(h, dA, (dt * x) * B); y's sum over each lane's 4 states in
    increasing s (a product, then fused multiply-adds), then over the
    channel's ds / 4 lanes by the xor tree of offsets 1, 2, 4: lane pairs
    (0, 1), (2, 3), ... first."""
    bsz, S, di = x.shape
    ds = B.shape[-1]
    h = torch.zeros((bsz, di, ds))
    ys = []
    for t in range(S):
        dtv = dt[:, t, :, None]
        dA = torch.exp(dtv * A)
        dx = (dt[:, t] * x[:, t])[..., None]
        h = _fma(h, dA, dx * B[:, t, None, :])
        hc = h.view(bsz, di, ds // 4, 4)
        cc = C[:, t].view(bsz, 1, ds // 4, 4)
        part = hc[..., 0] * cc[..., 0]
        for j in range(1, 4):
            part = _fma(hc[..., j], cc[..., j], part)
        while part.shape[-1] > 1:
            part = part[..., 0::2] + part[..., 1::2]
        ys.append(part[..., 0])
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("b,S,di,ds", [
    (2, 19, 12, 8),             # two lanes a channel
    (1, 40, 24, 16),            # four: the main path's ds
    (2, 23, 8, 32),             # eight
])
def test_s1_order_of_operations_matches_pallas_kernel(b, S, di, ds):
    """S1's fused multiply-adds and its per-lane, then xor-tree, sum for y
    stay within S1's tolerance on the card of the reference's Pallas
    kernel (interpret mode) and its oracle."""
    arrs = _inputs(100 * ds + S, b, S, di, ds)
    y, h = _emulate_s1(*map(torch.from_numpy, arrs))
    js = [jnp.asarray(a) for a in arrs]
    for want_y, want_h in (ref_kernel(*js, chunk=8, block_d=8,
                                      interpret=True),
                           ref_oracle(*js)):
        _close(y, want_y)
        _close(h, want_h)


# ------------------------------------------------------ on the card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,di,ds", [
    (4, 512, 8192, 16), (4, 77, 8192, 16), (1, 1, 16, 8), (2, 3, 5, 16),
    (1, 130, 200, 16), (2, 64, 32, 8), (1, 128, 256, 32),
    # around the 16-step chunk and its double buffer, and an odd 8
    (2, 7, 64, 16), (2, 8, 64, 16), (2, 9, 64, 16), (2, 15, 64, 16),
    (2, 16, 64, 16), (2, 17, 64, 16), (1, 513, 128, 16),
    # one channel, part of a warp, a ragged 64-channel block (4 B copies)
    (2, 40, 1, 16), (2, 40, 3, 16), (2, 40, 33, 16),
    # two and eight lanes a channel
    (3, 100, 200, 8), (3, 100, 200, 32), (3, 33, 33, 8), (3, 33, 33, 32)])
def test_s1_matches_plain_version(cuda, b, S, di, ds):
    x, dt, B, C, A = (torch.from_numpy(a).to(cuda)
                      for a in _inputs(1, b, S, di, ds))
    n = ops.LAUNCHES["selective_scan"]
    y, h = ops.mamba_scan(x, dt, B, C, A)
    assert ops.LAUNCHES["selective_scan"] == n + 1
    want_y, want_h = selective_scan_ref(x, dt, B, C, A)
    torch.testing.assert_close(y, want_y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(h, want_h, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("ds", [8, 16, 32])
def test_s1_lanes_do_not_depend_on_the_batch(cuda, ds):
    x, dt, B, C, A = (torch.from_numpy(a).to(cuda)
                      for a in _inputs(2, 4, 77, 1000, ds))
    y, h = ops.mamba_scan(x, dt, B, C, A)
    y2, h2 = ops.mamba_scan(x, dt, B, C, A)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for b in range(4):
        yb, hb = ops.mamba_scan(x[b:b + 1], dt[b:b + 1], B[b:b + 1],
                                C[b:b + 1], A)
        assert torch.equal(y[b:b + 1], yb) and torch.equal(h[b:b + 1], hb)


@pytest.mark.gpu
def test_s1_rejects_what_it_is_not_built_for(cuda):
    x, dt, B, C, A = (torch.from_numpy(a).to(cuda)
                      for a in _inputs(3, 1, 8, 16, 4))
    with pytest.raises(ValueError, match="state sizes"):
        ops.selective_scan_kernel(x, dt, B, C, A)
    x, dt, B, C, A = (torch.from_numpy(a).to(cuda)
                      for a in _inputs(3, 1, 8, 16, 8))
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan_kernel(x.bfloat16(), dt, B, C, A)
