"""Flash attention of the port (kernel F1's plain version on the CPU)
against the JAX package's Pallas kernel A4 in interpret mode and its
oracle, on the same numpy inputs.

Tolerances are the reference's own (`tests/test_kernels.py`): 2e-5 in
float32 (sums run in another order), 2e-2 in bfloat16 (one rounding of
the output). On the card, F1 is held to the plain version with the same
tolerances (the `gpu` tests below, and `chip_smoke.py`).

F1's bfloat16 kernel runs on the tensor cores and rounds P to bfloat16
before P.V. `_emulate_tensor_core_f1` repeats its tiling and rounding on
the CPU, so the design's numerics are held to the bfloat16 tolerance here,
where no card is.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     max_row_rel_err)
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
    (1, 128, 128, 4, 4, 112),       # zamba2-7b's shared block's head dim
    (2, 77, 256, 4, 4, 64),         # cross-attention: odd queries, more keys
    (1, 128, 384, 4, 2, 64),        # the same under GQA
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


# -------------------- the tensor-core design's numerics, emulated on the CPU

_TC_ROWS, _TC_KEYS = 128, 128      # F1's bf16 query tile and key tile


def _tc_key_end(q0, rows, Sq, Sk, causal):
    """Keys a query tile reads (flash_fwd_tc's k_end): up to its last row's
    position when causal, all Sk keys when a row precedes every key."""
    if causal and q0 + Sk - Sq >= 0:
        return min(Sk, q0 + rows + Sk - Sq)
    return Sk


def _emulate_tensor_core_f1(q, k, v, causal):
    """flash_fwd_tc's arithmetic in float32 torch: bf16 operands, products
    summed in fp32, exp2 of scores scaled by log2(e)/sqrt(hd), the running
    max and sum in fp32, P rounded to bf16 before P.V (l sums the fp32 p),
    128-row query tiles over 128-key tiles, the -1e30 mask, l floored at
    1e-30, the output rounded to bf16. (The kernel's ex2.approx, its FFMA
    of scale and max, and its multiply by 1/l differ from this by fp32
    roundings only.) q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                       # (B,H,Sq,hd)
    kf = k.float().repeat_interleave(H // Hkv, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(H // Hkv, 2).transpose(1, 2)
    scale = torch.tensor(1.0 / math.sqrt(hd) * 1.4426950408889634,
                         dtype=torch.float32)
    out = torch.empty_like(qf)
    for q0 in range(0, Sq, _TC_ROWS):
        rows = min(_TC_ROWS, Sq - q0)
        qpos = torch.arange(q0, q0 + rows)[:, None] + (Sk - Sq)
        m = torch.full((B, H, rows), -1e30)
        l = torch.zeros((B, H, rows))
        acc = torch.zeros((B, H, rows, hd))
        for k0 in range(0, _tc_key_end(q0, rows, Sq, Sk, causal), _TC_KEYS):
            ks = slice(k0, min(Sk, k0 + _TC_KEYS))
            s = (qf[:, :, q0:q0 + rows] @ kf[:, :, ks].transpose(-1, -2)) \
                * scale
            if causal:
                kpos = torch.arange(ks.start, ks.stop)[None, :]
                s = torch.where(kpos <= qpos, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] \
                + p.to(torch.bfloat16).float() @ vf[:, :, ks]
            m = m_new
        out[:, :, q0:q0 + rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (2, 128, 128, 4, 4, 64),
    (1, 512, 512, 4, 2, 128),       # qwen2-7b's hd, GQA, S 512
    (1, 256, 384, 4, 1, 128),       # a query suffix, Sq < Sk
    (1, 512, 512, 2, 2, 64),
    (1, 256, 256, 4, 4, 112),       # hd 112 on the hd-128 tiles
])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_match_pallas_kernel(B, Sq, Sk, H, Hkv, hd,
                                                  causal):
    """bf16 P (and bf16 operands with fp32 sums) stays inside the bf16
    tolerance against the reference's kernel and the plain version."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq + hd, B, Sq, Sk, H, Hkv, hd,
                                      "bfloat16")
    got = _f32(_emulate_tensor_core_f1(q, k, v, causal))
    want = ref_flash(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(got, _f32(want), atol=2e-2, rtol=2e-2)
    plain = flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got, _f32(plain), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (1, 1, 1, 2, 2, 64),            # S 1
    (4, 6, 6, 12, 12, 64),          # paper-demo's serving prompts
    (1, 77, 77, 4, 2, 128),         # no tile divides S
    (1, 200, 100, 4, 4, 64),        # Sq > Sk: rows before every key
    (2, 33, 300, 4, 1, 16),         # Sq < Sk over three key tiles, hd 16
    (1, 77, 77, 4, 4, 112),         # zamba2-7b's odd prompt, hd 112
])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_numerics_match_plain_at_odd_lengths(B, Sq, Sk, H, Hkv,
                                                         hd, causal):
    _, (q, k, v) = _inputs(Sq * Sk, B, Sq, Sk, H, Hkv, hd, "bfloat16")
    got = _emulate_tensor_core_f1(q, k, v, causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_max_row_rel_err_holds_each_row_to_its_own_scale():
    """An error of 5 % on a causal output's last row, whose values are
    far below the first row's, stays inside an absolute bound of 2e-2
    and reads 0.05 row by row; rows equal to the reference read 0."""
    _, (q, k, v) = _inputs(6, 1, 512, 512, 2, 2, 64, "float32")
    want = flash_attention_ref(q, k, v, causal=True)
    got = want.clone()
    got[0, -1, 0] += 0.05 * want[0, -1, 0].abs().max()
    assert float((got - want).abs().max()) < 2e-2
    assert max_row_rel_err(got, want) == pytest.approx(0.05, rel=1e-4)
    assert max_row_rel_err(want, want) == 0.0


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", [
    (1, 1024, 1024, 2, 1, 64, True),    # late causal rows over ~1000 keys
    (1, 128, 1024, 2, 2, 64, False),    # a cross-attention over 1024 keys
])
def test_tensor_core_design_rows_within_their_own_scale(B, Sq, Sk, H, Hkv,
                                                        hd, causal):
    """The tensor-core design's bf16 output holds every row within 2e-2 of
    that row's largest magnitude (`chip_smoke.py`'s per-row bound)."""
    _, (q, k, v) = _inputs(7, B, Sq, Sk, H, Hkv, hd, "bfloat16")
    got = _emulate_tensor_core_f1(q, k, v, causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert max_row_rel_err(got, want) <= 2e-2


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (5, 3), (3, 5), (300, 200),
                                   (130, 700)])
def test_tensor_core_key_end_covers_every_unmasked_key(Sq, Sk):
    """A causal query tile reads every key one of its rows attends to, and
    all Sk keys when a row precedes every key; the keys it skips are
    masked for all its rows."""
    for q0 in range(0, Sq, _TC_ROWS):
        rows = min(_TC_ROWS, Sq - q0)
        end = _tc_key_end(q0, rows, Sq, Sk, True)
        pos = [i + Sk - Sq for i in range(q0, q0 + rows)]
        if min(pos) < 0:
            assert end == Sk
        else:
            assert end == min(Sk, max(pos) + 1)


# ------------------------------- launch arguments: layouts and strides

def _offset(strides, b, s, h):
    return b * strides[0] + s * strides[1] + h * strides[2]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (2, 8, 8, 4, 2, 64),            # Sq == Sk, GQA
    (1, 3, 10, 4, 1, 16),           # Sq < Sk, MQA
    (3, 10, 3, 2, 2, 128),          # Sq > Sk
    (2, 1, 1, 4, 4, 64),            # S 1
    (2, 5, 7, 4, 4, 112),           # hd 112
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_args_address_every_element(B, Sq, Sk, H, Hkv, hd, dtype):
    """The (batch, seq, head) strides F1 is given address each element of
    both layouts where the tensor holds it, and the two layouts of the
    same storage give F1 the same arguments."""
    dt = getattr(torch, dtype)
    flat = [torch.zeros((B * n, S, hd), dtype=dt)
            for n, S in ((H, Sq), (Hkv, Sk), (Hkv, Sk), (H, Sq))]
    model = [t.view(B, -1, *t.shape[1:]).transpose(1, 2) for t in flat]
    a_flat = ops.launch_args(*flat, n_q_heads=H)
    a_model = ops.launch_args(*model)
    assert a_flat == a_model
    assert a_flat[:7] == (ops._DTYPES[dt], B, H, Hkv, Sq, Sk, hd)
    for i, (t, n, S) in enumerate(zip(model, (H, Hkv, Hkv, H),
                                      (Sq, Sk, Sk, Sq))):
        st = a_model[7 + 3 * i:10 + 3 * i]
        for b in range(B):
            for s_ in range(S):
                for h in range(n):
                    assert _offset(st, b, s_, h) == t[b, s_, h].storage_offset()
    # the model layout as the projections make it: (B, S, H, hd) contiguous
    q = torch.zeros((B, Sq, H, hd), dtype=dt)
    k = torch.zeros((B, Sk, Hkv, hd), dtype=dt)
    args = ops.launch_args(q, k, k, q)
    assert args[7:10] == tuple(
        hd if n == 1 else x for x, n in zip((Sq * H * hd, H * hd, hd),
                                            (B, Sq, H)))


def test_launch_args_take_only_16_byte_strides():
    """F1 reads a tensor in place only if its base and strides are whole
    16-byte steps and its head dimension is contiguous; the wrapper copies
    anything else first."""
    q = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    assert ops.in_place((q, q, q, q), ops.launch_args(q, q, q, q))
    wide = torch.zeros(2 * 8 * (4 * 64 + 4), dtype=torch.bfloat16)
    odd = wide.as_strided((2, 8, 4, 64), (8 * (4 * 64 + 4), 4 * 64 + 4,
                                          64, 1))
    shifted = wide[1:1 + q.numel()].view(q.shape)
    strided = torch.zeros((2, 8, 4, 128), dtype=torch.bfloat16)[..., ::2]
    for bad in (odd, shifted, strided):
        assert not ops.in_place((q, bad, q, q), ops.launch_args(q, bad, q, q))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_args_at_head_dim_112_take_zamba2_in_place(dtype):
    """zamba2-7b's shared block (32 heads on 32, hd 112) in the model
    layout: every stride is a whole 16-byte step (a bf16 row is 224 bytes,
    a sequence step 7168), so F1 reads it in place, and 112 is a head dim
    F1 is built for."""
    dt = getattr(torch, dtype)
    q = torch.zeros((4, 77, 32, 112), dtype=dt)
    args = ops.launch_args(q, q, q, q)
    assert args[6] == 112 and 112 in ops.HEAD_DIMS
    size = q.element_size()
    assert [st * size for st in args[7:10]] == [77 * 32 * 112 * size,
                                                32 * 112 * size, 112 * size]
    assert args[8] * 2 == 7168 and args[9] * 2 == 224
    assert ops.in_place((q, q, q, q), args)


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
    (1, 77, 77, 4, 2, 16), (1, 200, 100, 4, 4, 64),
    (4, 512, 512, 32, 32, 112), (2, 77, 200, 8, 2, 112),
    (4, 1024, 1024, 16, 16, 64), (4, 512, 1024, 16, 16, 64),
    (4, 77, 1024, 16, 16, 64)])
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
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (1, 1, 1, 2, 2, 64), (4, 4, 4, 12, 12, 64), (4, 6, 6, 12, 12, 64),
    (4, 77, 77, 28, 4, 128), (4, 512, 512, 28, 4, 128),
    (2, 512, 512, 4, 4, 16), (2, 33, 300, 4, 1, 16), (1, 128, 640, 28, 4, 128),
    (1, 200, 100, 4, 4, 64), (2, 300, 129, 4, 2, 128),
    (4, 77, 77, 32, 32, 112), (2, 300, 129, 4, 2, 112)])
@pytest.mark.parametrize("causal", [True, False])
def test_f1_tensor_cores_match_plain_version(cuda, B, Sq, Sk, H, Hkv, hd,
                                             causal):
    _, (q, k, v) = _inputs(3, B, Sq, Sk, H, Hkv, hd, "bfloat16")
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.is_contiguous() and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", [
    (2, 3072, 3072, 56, 8, 128, True),       # llava-next-34b's prefill
    (1, 2048, 2048, 16, 16, 64, True),
    (4, 1024, 1024, 16, 16, 64, False),      # seamless's encoder
    (4, 512, 1024, 16, 16, 64, False)])      # and its cross-attention
def test_f1_bf16_rows_within_their_own_scale(cuda, B, Sq, Sk, H, Hkv, hd,
                                             causal):
    """F1's bf16 output holds every row (one query of one head) within
    2e-2 of that row's largest magnitude, where the late rows of a long
    causal prompt and the rows over 1024 keys are far below 1."""
    _, (q, k, v) = _inputs(5, B, Sq, Sk, H, Hkv, hd, "bfloat16")
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    assert max_row_rel_err(got, want) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "flash_fwd_tc"),
                                          ("float32", "flash_fwd_fma")])
def test_f1_dispatches_by_dtype(cuda, dtype, kernel):
    """bf16 always runs the tensor-core kernel, even at S 1; float32 the
    FMA kernel."""
    from torch.profiler import ProfilerActivity, profile
    for S in (1, 512):
        _, (q, k, v) = _inputs(4, 1, S, S, 4, 2, 64, dtype)
        q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        assert any(kernel in n for n in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_f1_model_layout_equals_flattened_layout(cuda, dtype):
    """The model layout read by strides gives the bits of the flattened
    layout, and its output is written in (B, Sq, H, hd) order."""
    B, Sq, Sk, H, Hkv, hd = 4, 77, 200, 28, 4, 128
    _, (q, k, v) = _inputs(5, B, Sq, Sk, H, Hkv, hd, dtype)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    for causal in (True, False):
        model = ops.flash_attention_kernel(q, k, v, causal=causal)
        flat = ops.flash_attention_bhsd_kernel(
            *(t.transpose(1, 2).reshape(-1, t.shape[1], hd)
              for t in (q, k, v)), causal=causal, n_q_heads=H)
        assert model.stride() == (Sq * H * hd, H * hd, hd, 1)
        assert torch.equal(model, flat.view(B, H, Sq, hd).transpose(1, 2))


@pytest.mark.gpu
def test_f1_rows_do_not_depend_on_the_batch(cuda):
    _, (q, k, v) = _inputs(2, 4, 77, 77, 28, 4, 128, "bfloat16")
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    whole = ops.flash_attention(q, k, v, causal=True)
    for b in range(4):
        alone = ops.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    causal=True)
        assert torch.equal(whole[b:b + 1], alone)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 96, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f1_refuses_a_head_dim_it_is_not_built_for(cuda, hd, dtype):
    """No fallback: a CUDA tensor at a head dim F1 is not built for
    raises, and nothing launches."""
    _, (q, k, v) = _inputs(6, 1, 8, 8, 2, 2, hd, dtype)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    n = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == n
