"""Mamba1 (selective scan, the ssm family) and Mamba2 (SSD, the hybrid
family's layers) blocks: init, the chunked forward, prefill with state
capture and single-token decode.

The reference's training forward runs a *chunked* scan: a sequential loop
over sequence chunks carrying the SSM state, with parallel work inside
each chunk. The port keeps that route. Mamba1's intra-chunk scan is a
log-depth doubling scan in torch ops, which multiplies decay factors and
never divides by them (a cumulative product of `exp(dt*A)` underflows to 0
at real `dt` and `A`). Mamba2's chunk is the reference's SSD: `_segsum`'s
cumsum differences under a -inf mask, then einsums (`_ssd_chunk`), copied
formula for formula.

The reference's docstring names its Pallas kernel A5 as what replaces the
chunked Mamba1 scan on the TPU, but only its `mamba1_forward_pallas`
binding calls it. The port routes Mamba1 prefill through the kernel (S1 on
the card, its plain version on the CPU) when `ExecConfig.attn_impl ==
"pallas"`, the knob that already means "the repo's kernels" (ROADMAP C5).
The training forward stays on the chunked scan: S1 has no backward. The
reference computes the SSD outside any Pallas kernel, so Mamba2 runs the
chunked SSD under every `attn_impl`; S1 is Mamba1's scan only.

Two faults of the reference's prefill are not copied, in either version: a
prompt shorter than `ssm_conv - 1` gets a conv state left-padded with
zeros (the causal conv's zero initial state) instead of a short one
(ROADMAP C3), and the chunked route raises a ValueError naming its chunk
rule instead of failing in a reshape or an assert (C4).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ops as scan_ops
from ..sharding.partition import shard_constraint
from .config import ModelConfig
from .layers import _init, rmsnorm, rmsnorm_init, torch_dtype

Params = Any


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ------------------------------------------------------------------- mamba1

def mamba1_init(gen, cfg: ModelConfig, dtype, lead=()):
    D, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(D // 16, 1)
    tdt = torch_dtype(dtype)
    full = lambda shape, v: torch.full((*lead, *shape), v, dtype=tdt,
                                       device=gen.device)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=gen.device).to(tdt))
    return {
        "in_x": _init(gen, (*lead, D, di), dtype),
        "in_z": _init(gen, (*lead, D, di), dtype),
        "conv_w": _init(gen, (*lead, cfg.ssm_conv, di), dtype, scale=0.5),
        "conv_b": full((di,), 0.0),
        "x_proj": _init(gen, (*lead, di, dt_rank + 2 * ds), dtype),
        "dt_proj": _init(gen, (*lead, dt_rank, di), dtype),
        "dt_bias": full((di,), 0.0),
        "A_log": a_log.expand(*lead, di, ds).contiguous(),
        "D": full((di,), 1.0),
        "out_proj": _init(gen, (*lead, di, D), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,C); w: (K,C). Returns (y, last K-1
    rows of [init_state, x])."""
    K, S = w.shape[0], x.shape[1]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([init_state, x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return y + b, xp[:, xp.shape[1] - (K - 1):]


def _conv_tail(pre: torch.Tensor, K: int) -> torch.Tensor:
    """The conv state after a prompt: the last K-1 rows of the conv's
    input (B,S,C), in float32. A prompt shorter than K-1 is left-padded
    with the zeros the causal conv starts from (ROADMAP C3)."""
    tail = pre[:, max(pre.shape[1] - (K - 1), 0):].float()
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


def _chunk_scan_m1(dA, dBx, h0):
    """Intra-chunk scan. dA, dBx: (B,c,di,ds); h0: (B,di,ds). Returns the
    per-step states (B,c,di,ds) and the final carry (B,di,ds).

    The reference's `jax.lax.associative_scan` over (a, b) pairs with
    combine((al, bl), (ar, br)) = (al*ar, ar*bl + br), as a Hillis-Steele
    doubling scan: log2(c) rounds of elementwise products."""
    a = torch.cat([torch.ones_like(dA[:, :1]), dA], dim=1)
    b = torch.cat([h0[:, None], dBx], dim=1)
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b[:, 1:], b[:, -1]


def _chunk_len(cfg: ModelConfig, S: int) -> int:
    c = min(cfg.ssm_chunk, S)
    if c <= 0 or S % c:
        other = ("attn_impl='pallas' takes any S" if cfg.ssm_version == 1
                 else "Mamba2 runs the chunked SSD under every attn_impl")
        raise ValueError(
            f"the chunked scan needs S % min(ssm_chunk, S) == 0, got S {S} "
            f"with ssm_chunk {cfg.ssm_chunk} (ROADMAP C4); {other}")
    return c


def _mamba1_inputs(p, x, cfg: ModelConfig, cd, conv_state=None):
    """The projections around the scan. x: (B,S,D) -> (xi_pre, xi, z, dt,
    Bc, Cc, A, new conv state): xi_pre before the conv, xi after conv and
    silu, dt after softplus, all (B,S,di) in `cd` but Bc, Cc (B,S,ds) and
    A = -exp(A_log) (di,ds) float32."""
    ds = cfg.ssm_state
    dt_rank = max(cfg.d_model // 16, 1)
    xc = x.to(cd)
    xi_pre = xc @ p["in_x"].to(cd)
    z = xc @ p["in_z"].to(cd)
    xi, conv_out = _causal_conv(xi_pre, p["conv_w"].to(cd),
                                p["conv_b"].to(cd), conv_state)
    xi = F.silu(xi)
    proj = xi @ p["x_proj"].to(cd)
    dt, Bc, Cc = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    dt = _softplus(dt @ p["dt_proj"].to(cd) + p["dt_bias"].to(cd))
    A = -torch.exp(p["A_log"].float())
    # the scan runs per lane and channel: lanes over the batch axes,
    # channels over the heads axis
    xi = shard_constraint(xi, "batch", None, "heads")
    dt = shard_constraint(dt, "batch", None, "heads")
    return xi_pre, xi, z, dt, Bc, Cc, A, conv_out


def _chunked_scan(xi, dt, Bc, Cc, A, c: int, cd):
    """The reference's chunked scan from h = 0: (y (B,S,di) in `cd`,
    h_final (B,di,ds) float32)."""
    bsz, S, di = xi.shape
    h = torch.zeros((bsz, di, A.shape[1]), dtype=torch.float32,
                    device=xi.device)
    ys = []
    for j in range(0, S, c):
        dtf = dt[:, j:j + c].float()
        dA = torch.exp(dtf[..., None] * A)                   # (B,c,di,ds)
        dBx = (dtf * xi[:, j:j + c].float())[..., None] \
            * Bc[:, j:j + c].float()[..., None, :]
        hs, h = _chunk_scan_m1(dA, dBx, h)
        ys.append(torch.einsum("bcds,bcs->bcd", hs,
                               Cc[:, j:j + c].float()).to(cd))
    return torch.cat(ys, dim=1), h


def _kernel_scan(xi, dt, Bc, Cc, A, cd):
    """The scan through `kernels.mamba_scan` (S1 on the card), in fp32 as
    the reference's binding passes it: (y in `cd`, h_final float32)."""
    y, h = scan_ops.mamba_scan(xi.float(), dt.float(), Bc.float(),
                               Cc.float(), A)
    return y.to(cd), h


def _mamba1_out(p, y, xi, z, cd):
    y = y + xi * p["D"].to(cd)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(cd)


def mamba1_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   compute_dtype=torch.bfloat16):
    """x: (B,S,D) -> (B,S,D). Chunked selective scan, whatever attn_impl
    is: it is the route with a gradient."""
    c = _chunk_len(cfg, x.shape[1])
    _, xi, z, dt, Bc, Cc, A, _ = _mamba1_inputs(p, x, cfg, compute_dtype)
    y, _ = _chunked_scan(xi, dt, Bc, Cc, A, c, compute_dtype)
    return _mamba1_out(p, y, xi, z, compute_dtype)


def mamba1_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None, lead=()):
    di, ds, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    shapes = {"h": (batch, di, ds), "conv": (batch, K - 1, di)}
    return {k: torch.zeros((*lead, *s), dtype=dtype, device=device)
            for k, s in shapes.items()}


def mamba1_step(p: Params, x: torch.Tensor, state, cfg: ModelConfig,
                compute_dtype=torch.bfloat16):
    """Single-token decode. x: (B,1,D); state: {h: (B,di,ds), conv:
    (B,K-1,di)}. Returns (out (B,1,D), new state)."""
    cd = compute_dtype
    _, xi, z, dt, Bc, Cc, A, conv_state = _mamba1_inputs(
        p, x, cfg, cd, state["conv"].to(cd))
    dtf = dt[:, 0].float()                                   # (B,di)
    dA = torch.exp(dtf[..., None] * A)                       # (B,di,ds)
    dBx = (dtf * xi[:, 0].float())[..., None] \
        * Bc[:, 0].float()[:, None, :]
    h = state["h"] * dA + dBx
    y = torch.einsum("bds,bs->bd", h, Cc[:, 0].float())
    out = _mamba1_out(p, y.to(cd)[:, None], xi, z, cd)
    return out, {"h": h, "conv": conv_state.to(state["conv"].dtype)}


def mamba1_forward_with_state(p: Params, x: torch.Tensor, cfg: ModelConfig,
                              compute_dtype=torch.bfloat16, *,
                              impl: str = "chunked"):
    """Prefill: the forward plus the final recurrent state {h: (B,di,ds),
    conv: (B,K-1,di)}, both float32. `impl == "pallas"` runs the scan
    through `kernels.mamba_scan` (S1 on the card; any S), any other value
    the reference's chunked scan (S % min(ssm_chunk, S) == 0)."""
    cd = compute_dtype
    S, K = x.shape[1], cfg.ssm_conv
    c = None if impl == "pallas" else _chunk_len(cfg, S)
    xi_pre, xi, z, dt, Bc, Cc, A, _ = _mamba1_inputs(p, x, cfg, cd)
    conv = _conv_tail(xi_pre, K)
    if c is None:
        y, h = _kernel_scan(xi, dt, Bc, Cc, A, cd)
    else:
        y, h = _chunked_scan(xi, dt, Bc, Cc, A, c, cd)
    return _mamba1_out(p, y, xi, z, cd), {"h": h, "conv": conv}


def mamba1_forward_pallas(p: Params, x: torch.Tensor, cfg: ModelConfig,
                          compute_dtype=torch.bfloat16):
    """`mamba1_forward` with the scan through `kernels.mamba_scan` (S1 on
    the card) instead of the chunked scan: the reference's binding of its
    kernel A5. Forward only."""
    _, xi, z, dt, Bc, Cc, A, _ = _mamba1_inputs(p, x, cfg, compute_dtype)
    y, _ = _kernel_scan(xi, dt, Bc, Cc, A, compute_dtype)
    return _mamba1_out(p, y, xi, z, compute_dtype)


# ------------------------------------------------------------------- mamba2

def mamba2_init(gen, cfg: ModelConfig, dtype, lead=()):
    D, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    tdt = torch_dtype(dtype)
    full = lambda shape, v: torch.full((*lead, *shape), v, dtype=tdt,
                                       device=gen.device)
    return {
        "in_z": _init(gen, (*lead, D, di), dtype),
        "in_x": _init(gen, (*lead, D, di), dtype),
        "in_bc": _init(gen, (*lead, D, 2 * ds), dtype),
        "in_dt": _init(gen, (*lead, D, nh), dtype),
        "conv_w": _init(gen, (*lead, cfg.ssm_conv, di), dtype, scale=0.5),
        "conv_b": full((di,), 0.0),
        "conv_bc_w": _init(gen, (*lead, cfg.ssm_conv, 2 * ds), dtype,
                           scale=0.5),
        "conv_bc_b": full((2 * ds,), 0.0),
        "dt_bias": full((nh,), 0.0),
        "A_log": full((nh,), 0.0),
        "D": full((nh,), 1.0),
        "norm": rmsnorm_init(di, dtype, gen.device, lead),
        "out_proj": _init(gen, (*lead, di, D), dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., c) -> (..., c, c) lower-triangular segment sums: entry
    (i, j) is sum(x[j+1..i]) as the difference of two cumsums, -inf above
    the diagonal (the reference's formula)."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def _ssd_chunk(xc, dtc, bc, cc, A, h0):
    """One SSD chunk. xc: (B,c,nh,hp); dtc: (B,c,nh); bc, cc: (B,c,ds);
    A: (nh,); h0: (B,nh,hp,ds). Returns (y (B,c,nh,hp), h_next)."""
    dA = dtc * A                                             # (B,c,nh)
    L = torch.exp(_segsum(dA.transpose(1, 2)))               # (B,nh,c,c)
    # diagonal (intra-chunk) term: attention-like matmuls
    G = torch.einsum("bqs,bks->bqk", cc, bc)                 # (B,c,c)
    M = G[:, None] * L                                       # (B,nh,c,c)
    y_diag = torch.einsum("bhqk,bkh,bkhp->bqhp", M, dtc, xc)
    # state at chunk end
    cum = torch.cumsum(dA, dim=1)
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)           # (B,c,nh)
    h_new = torch.einsum("bkh,bkh,bkhp,bks->bhps", decay_to_end, dtc, xc, bc)
    h_next = h0 * torch.exp(cum[:, -1])[:, :, None, None] + h_new
    # off-diagonal: contribution of the incoming state
    y_off = torch.einsum("bqs,bqh,bhps->bqhp", cc, torch.exp(cum), h0)
    return y_diag + y_off, h_next


def _mamba2_inputs(p, x, cfg: ModelConfig, cd, conv_state=None):
    """The projections around the SSD. x: (B,S,D) -> (z, xi_pre, bc_pre,
    xi, Bc, Cc, dt, A, new conv state): z, xi_pre (before the conv) and
    xi (after conv and silu) (B,S,di), bc_pre (B,S,2ds), Bc, Cc (B,S,ds),
    dt (B,S,nh) after softplus, all in `cd`; A = -exp(A_log) (nh,) float32.
    `conv_state` (B,K-1,di+2ds) continues the convs (decode)."""
    di = cfg.d_inner
    xc = x.to(cd)
    z = xc @ p["in_z"].to(cd)
    xi_pre = xc @ p["in_x"].to(cd)
    bc_pre = xc @ p["in_bc"].to(cd)
    dt = xc @ p["in_dt"].to(cd)
    sx = sbc = None
    if conv_state is not None:
        sx, sbc = conv_state[..., :di].to(cd), conv_state[..., di:].to(cd)
    xi, conv_x = _causal_conv(xi_pre, p["conv_w"].to(cd), p["conv_b"].to(cd),
                              sx)
    bc, conv_bc = _causal_conv(bc_pre, p["conv_bc_w"].to(cd),
                               p["conv_bc_b"].to(cd), sbc)
    xi = F.silu(xi)
    Bc, Cc = F.silu(bc).chunk(2, dim=-1)
    dt = _softplus(dt + p["dt_bias"].to(cd))
    A = -torch.exp(p["A_log"].float())
    # the SSD runs per lane and SSM head: lanes over the batch axes, the
    # inner channels and heads over the heads axis
    xi = shard_constraint(xi, "batch", None, "heads")
    dt = shard_constraint(dt, "batch", None, "heads")
    return (z, xi_pre, bc_pre, xi, Bc, Cc, dt, A,
            torch.cat([conv_x, conv_bc], dim=-1))


def _ssd(xi, dt, Bc, Cc, A, cfg: ModelConfig, c: int, cd):
    """The reference's chunked SSD from h = 0: (y (B,S,di) in `cd`,
    h_final (B,nh,hp,ds) float32)."""
    B, S, di = xi.shape
    nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
    xh = xi.reshape(B, S, nh, hp).float()
    dtf, Bf, Cf = dt.float(), Bc.float(), Cc.float()
    h = torch.zeros((B, nh, hp, cfg.ssm_state), dtype=torch.float32,
                    device=xi.device)
    ys = []
    for j in range(0, S, c):
        y, h = _ssd_chunk(xh[:, j:j + c], dtf[:, j:j + c], Bf[:, j:j + c],
                          Cf[:, j:j + c], A, h)
        ys.append(y.to(cd))
    return torch.cat(ys, dim=1).reshape(B, S, di), h


def _mamba2_out(p, y, xi, z, cfg: ModelConfig, cd):
    y = y + xi * torch.repeat_interleave(p["D"].to(cd), cfg.ssm_head_dim)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"].to(cd)


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   compute_dtype=torch.bfloat16):
    """x: (B,S,D) -> (B,S,D), the chunked SSD (S % min(ssm_chunk, S) ==
    0, ROADMAP C4)."""
    c = _chunk_len(cfg, x.shape[1])
    z, _, _, xi, Bc, Cc, dt, A, _ = _mamba2_inputs(p, x, cfg, compute_dtype)
    y, _ = _ssd(xi, dt, Bc, Cc, A, cfg, c, compute_dtype)
    return _mamba2_out(p, y, xi, z, cfg, compute_dtype)


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device=None, lead=()):
    di, ds, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
    shapes = {"h": (batch, nh, hp, ds), "conv": (batch, K - 1, di + 2 * ds)}
    return {k: torch.zeros((*lead, *s), dtype=dtype, device=device)
            for k, s in shapes.items()}


def mamba2_step(p: Params, x: torch.Tensor, state, cfg: ModelConfig,
                compute_dtype=torch.bfloat16):
    """Single-token decode. x: (B,1,D); state: {h: (B,nh,hp,ds), conv:
    (B,K-1,di+2ds)}. Returns (out (B,1,D), new state)."""
    cd = compute_dtype
    B = x.shape[0]
    nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
    z, _, _, xi, Bc, Cc, dt, A, conv_state = _mamba2_inputs(
        p, x, cfg, cd, state["conv"])
    xf = xi[:, 0].reshape(B, nh, hp).float()
    dtf = dt[:, 0].float()                                   # (B,nh)
    dA = torch.exp(dtf * A)                                  # (B,nh)
    h = state["h"] * dA[:, :, None, None] \
        + torch.einsum("bh,bhp,bs->bhps", dtf, xf, Bc[:, 0].float())
    y = torch.einsum("bhps,bs->bhp", h, Cc[:, 0].float())
    y = y + xf * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, cfg.d_inner).to(cd)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return (y @ p["out_proj"].to(cd),
            {"h": h, "conv": conv_state.to(state["conv"].dtype)})


def mamba2_forward_with_state(p: Params, x: torch.Tensor, cfg: ModelConfig,
                              compute_dtype=torch.bfloat16):
    """Prefill: the forward plus the final recurrent state {h:
    (B,nh,hp,ds), conv: (B,K-1,di+2ds)}, both float32. The chunked SSD
    (S % min(ssm_chunk, S) == 0, ROADMAP C4); the conv tail of a prompt
    shorter than K-1 is zero-padded (C3)."""
    cd = compute_dtype
    c = _chunk_len(cfg, x.shape[1])
    z, xi_pre, bc_pre, xi, Bc, Cc, dt, A, _ = _mamba2_inputs(p, x, cfg, cd)
    conv = _conv_tail(torch.cat([xi_pre, bc_pre], dim=-1), cfg.ssm_conv)
    y, h = _ssd(xi, dt, Bc, Cc, A, cfg, c, cd)
    return _mamba2_out(p, y, xi, z, cfg, cd), {"h": h, "conv": conv}


# ------------------------------------------------------------- dispatchers

def mamba_init(gen, cfg: ModelConfig, dtype, lead=()):
    init = mamba1_init if cfg.ssm_version == 1 else mamba2_init
    return init(gen, cfg, dtype, lead)


def mamba_forward(p, x, cfg: ModelConfig, compute_dtype=torch.bfloat16):
    fwd = mamba1_forward if cfg.ssm_version == 1 else mamba2_forward
    return fwd(p, x, cfg, compute_dtype)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead=()):
    init = mamba1_init_state if cfg.ssm_version == 1 else mamba2_init_state
    return init(cfg, batch, dtype, device, lead)


def mamba_step(p, x, state, cfg: ModelConfig, compute_dtype=torch.bfloat16):
    step = mamba1_step if cfg.ssm_version == 1 else mamba2_step
    return step(p, x, state, cfg, compute_dtype)


def mamba_forward_with_state(p, x, cfg: ModelConfig,
                             compute_dtype=torch.bfloat16, *,
                             impl: str = "chunked"):
    """Prefill with state capture. `impl` picks Mamba1's scan route (S1
    under "pallas"); Mamba2 runs the chunked SSD under every `impl`."""
    if cfg.ssm_version == 1:
        return mamba1_forward_with_state(p, x, cfg, compute_dtype, impl=impl)
    return mamba2_forward_with_state(p, x, cfg, compute_dtype)
