"""Plain float32 reference of a Mamba1 language model (the ssm family:
falcon-mamba-7b's layers as the port computes them), and its seeded
weights.

Per layer, on the RMS-normed residual x (S, D):
    xi = silu(causal_conv(x @ in_x) + conv_b),  z = x @ in_z
    dt, B, C = split(xi @ x_proj);  dt = softplus(dt @ dt_proj + dt_bias)
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * xi_t) B_t,  A = -exp(A_log)
    y_t = (h_t . C_t + D * xi_t) * silu(z_t);  x += y @ out_proj
then the final RMSNorm and the logits against the embedding table (the
port ties the unembedding to it). Every operation is float32; the scan is
the recurrence itself, step by step, batched over a block of requests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (TABLE_STD, float32_exact, mm, normal, residual_std,
                     rmsnorm, uniform)

#: requests a block (sorted by length, padded to the block's longest)
BLOCK = 12
#: scan steps whose decay and input terms are formed at once
CHUNK = 64


def make_weights(sz, seed: int, device) -> dict:
    """Seeded float32 weights in the port's layout. Projections at
    1/sqrt(fan_in); out_proj shrunk for depth; Mamba's own initialisation
    of dt (softplus(dt_bias) log-uniform over 1e-3..1e-1, dt_proj uniform
    within dt_rank^-1/2), A_log = log(1..ds), D = 1; the embedding at TABLE_STD."""
    float32_exact()
    L, D, di, ds, K = sz.n_layers, sz.d_model, sz.d_inner, sz.ssm_state, \
        sz.ssm_conv
    dtr = max(D // 16, 1)
    g = torch.Generator(device=device).manual_seed(int(seed))
    dt = torch.exp(uniform(g, (L, di), math.log(1e-3), math.log(1e-1)))
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device))
    layers = {
        "ln": {"scale": torch.ones((L, D), device=device)},
        "mamba": {
            "in_x": normal(g, (L, D, di), D ** -0.5),
            "in_z": normal(g, (L, D, di), D ** -0.5),
            "conv_w": uniform(g, (L, K, di), -K ** -0.5, K ** -0.5),
            "conv_b": uniform(g, (L, di), -K ** -0.5, K ** -0.5),
            "x_proj": normal(g, (L, di, dtr + 2 * ds), di ** -0.5),
            "dt_proj": uniform(g, (L, dtr, di), -dtr ** -0.5, dtr ** -0.5),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "A_log": a_log.expand(L, di, ds).contiguous(),
            "D": torch.ones((L, di), device=device),
            "out_proj": normal(g, (L, di, D),
                               residual_std(di, L) * math.sqrt(2)),
        },
    }
    return {"embedding": {"table": normal(g, (sz.vocab_size, D), TABLE_STD)},
            "stack": {"layers": layers},
            "ln_f": {"scale": torch.ones((D,), device=device)}}


def _scan(xi, dt, Bm, Cm, A):
    """y (b, S, di) of the selective scan from h = 0, float32."""
    b, S, di = xi.shape
    h = xi.new_zeros((b, di, A.shape[1]))
    y = torch.empty_like(xi)
    for t0 in range(0, S, CHUNK):
        t1 = min(S, t0 + CHUNK)
        dtc = dt[:, t0:t1].transpose(0, 1)                   # (T, b, di)
        dA = torch.exp(dtc[..., None] * A)                   # (T, b, di, ds)
        dBx = (dtc * xi[:, t0:t1].transpose(0, 1))[..., None] \
            * Bm[:, t0:t1].transpose(0, 1)[:, :, None, :]
        hs = torch.empty_like(dA)
        for t in range(t1 - t0):
            h = torch.addcmul(dBx[t], h, dA[t], out=hs[t])
        y[:, t0:t1] = torch.einsum("tbds,tbs->btd", hs,
                                   Cm[:, t0:t1].transpose(0, 1))
    return y


def _layer(p, i: int, x, sz, quant):
    """One Mamba1 block on x (b, S, D), in place of nothing: returns x."""
    ds, K = sz.ssm_state, sz.ssm_conv
    dtr = max(sz.d_model // 16, 1)
    m = {k: v[i] for k, v in p["mamba"].items()}
    b, S, D = x.shape
    h = rmsnorm(x, p["ln"]["scale"][i], sz.norm_eps).reshape(b * S, D)
    xi = mm(h, m["in_x"], quant).reshape(b, S, -1)
    z = mm(h, m["in_z"], quant).reshape(b, S, -1)
    del h
    pad = F.pad(xi, (0, 0, K - 1, 0))
    conv = m["conv_b"] + sum(pad[:, j:j + S] * m["conv_w"][j]
                             for j in range(K))
    xi = F.silu(conv)
    del pad, conv
    proj = mm(xi.reshape(b * S, -1), m["x_proj"], quant)
    dt = F.softplus(mm(proj[:, :dtr].contiguous(), m["dt_proj"], quant)
                    + m["dt_bias"]).reshape(b, S, -1)
    Bm = proj[:, dtr:dtr + ds].reshape(b, S, ds)
    Cm = proj[:, dtr + ds:].reshape(b, S, ds)
    y = _scan(xi, dt, Bm, Cm, -torch.exp(m["A_log"]))
    del dt
    y = (y + xi * m["D"]) * F.silu(z)
    del xi, z
    return x + mm(y.reshape(b * S, -1), m["out_proj"], quant).reshape(
        b, S, D)


def logits_at(params, sz, requests, *, lanes: int = 1, quant=None):
    """float32 logits (n_i, V) at the n_i positions that produced each
    request's n_i served tokens; `requests` is [(prompt, served), ...].
    `lanes` (the prefill's lane count) does not change a Mamba1 lane."""
    float32_exact()
    dev = params["embedding"]["table"].device
    table = params["embedding"]["table"]
    layers = params["stack"]["layers"]
    out = [None] * len(requests)
    order = sorted(range(len(requests)),
                   key=lambda i: len(requests[i][0]) + len(requests[i][1]))
    with torch.no_grad():
        for k in range(0, len(order), BLOCK):
            idx = order[k:k + BLOCK]
            seqs = [list(requests[i][0]) + list(requests[i][1][:-1])
                    for i in idx]
            S = max(len(s) for s in seqs)
            toks = torch.zeros((len(seqs), S), dtype=torch.long, device=dev)
            for r, s in enumerate(seqs):
                toks[r, :len(s)] = torch.tensor(s, device=dev)
            x = table[toks]
            for i in range(sz.n_layers):
                x = _layer(layers, i, x, sz, quant)
            for r, i in enumerate(idx):
                n, end = len(requests[i][1]), len(seqs[r])
                hN = rmsnorm(x[r, end - n:end], params["ln_f"]["scale"],
                             sz.norm_eps)
                out[i] = mm(hN, table.T, quant)
            del x
    return out
