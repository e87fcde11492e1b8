"""Primitive layers shared by all architectures.

Pure functions over explicit parameter trees (nested dicts of tensors with
the JAX package's leaf names), so checkpoints read in both packages.
Initializers draw from a `torch.Generator`; the numbers differ from
`jax.random`'s, so parity tests carry the JAX parameters across with
`models.model.params_from_jax` instead.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding.partition import shard_constraint

Params = Any


def torch_dtype(name) -> torch.dtype:
    """numpy dtype name (`float32`, `bfloat16`...) -> torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------- init utils

def _init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) > 1 else max(shape[-1], 1)
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(torch_dtype(dtype))


def dense_init(gen, d_in, d_out, dtype):
    return {"w": _init(gen, (d_in, d_out), dtype)}


def dense(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x.to(compute_dtype) @ p["w"].to(compute_dtype)


# ------------------------------------------------------------------ rmsnorm

def rmsnorm_init(d, dtype, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=torch_dtype(dtype),
                                device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# --------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return 1.0 / (theta ** e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs       # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- gated mlp

def mlp_init(gen, d_model, d_ff, dtype, gated: bool = True, lead=()):
    p = {
        "wi_up": _init(gen, (*lead, d_model, d_ff), dtype),
        "wo": _init(gen, (*lead, d_ff, d_model), dtype),
    }
    if gated:
        p["wi_gate"] = _init(gen, (*lead, d_model, d_ff), dtype)
    return p


def mlp(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    xc = x.to(compute_dtype)
    u = xc @ p["wi_up"].to(compute_dtype)
    if "wi_gate" in p:
        g = xc @ p["wi_gate"].to(compute_dtype)
        h = F.silu(g) * u
    else:
        h = F.gelu(u, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["wo"].to(compute_dtype)


# --------------------------------------------------------------- embeddings

def embedding_init(gen, vocab, d_model, dtype):
    return {"table": _init(gen, (vocab, d_model), dtype, scale=1.0)}


def embed(p: Params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # Under a mesh: F.embedding, not `table[tokens]`, whose backward by a
    # split index fails in DTensor's rule for index_put (torch 2.11); and
    # the rows laid out by lane at once, since a vocab-split table gives a
    # pending masked sum that DTensor cannot reduce into a split dim
    x = F.embedding(tokens.long(), p["table"].to(compute_dtype))
    return shard_constraint(x, "batch", None, None)


def unembed(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x.to(compute_dtype) @ p["table"].to(compute_dtype).T
