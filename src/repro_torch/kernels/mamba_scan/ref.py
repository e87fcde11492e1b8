"""Plain PyTorch version of the Mamba1 selective scan: the straight
recurrence of the JAX package's `selective_scan_ref`, in fp32.

The CPU tests hold it against the Pallas kernel in interpret mode, the
port's wrapper takes it for CPU tensors, and `chip_smoke.py` holds the
CUDA kernel S1 against it on the card. Nothing on the CUDA path calls it.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor, h0=None):
    """x, dt: (batch, S, di); B, C: (batch, S, ds); A: (di, ds).

    h_t = exp(dt_t ⊙ A) * h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
    y_t = h_t · C_t
    Returns (y (batch, S, di) in x's dtype, h_final (batch, di, ds)
    fp32); h starts at `h0` (zeros if None). All math fp32.
    """
    bsz, S, di = x.shape
    ds = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    h = torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)                 # (b, di, ds)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = h * dA + dBx
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, di))
    return y.to(x.dtype), h
