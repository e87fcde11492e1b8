"""Layer stack of the dense family.

Layer parameters are stacked with a leading L axis under `layers`, as in
the JAX package, so leaf paths and checkpoints match. Where the reference
scans over that axis, the port loops over it in Python; `remat_policy`
"full" recomputes each block in the backward pass through
`torch.utils.checkpoint`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from .config import ModelConfig
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init

Params = Any


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs of the dense path."""
    attn_impl: str = "chunked"        # naive | chunked (pallas: slice 2)
    remat_policy: str = "full"        # none | full
    xent_chunks: int = 4


def dense_block_init(gen, cfg: ModelConfig, dtype, lead=()):
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "attn": attn_mod.attention_init(gen, cfg, dtype, lead),
        "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.mlp_gated,
                        lead),
    }


def dense_block(p, x, cfg: ModelConfig, ec: ExecConfig, positions, dt):
    h = x + attn_mod.attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg, positions=positions, impl=ec.attn_impl,
                               compute_dtype=dt)
    return h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), dt)


def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: only 'dense' is "
            "(ROADMAP queue A, slice 4)")


def stack_init(gen, cfg: ModelConfig, dtype) -> Params:
    """Stacked layer params (leading L axis) of the decoder stack."""
    _require_dense(cfg)
    return {"layers": dense_block_init(gen, cfg, dtype, lead=(cfg.n_layers,))}


def _layer(layers, i: int):
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def stack_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  ec: ExecConfig, positions, dt):
    """x: (B,S,D) -> ((B,S,D), aux_loss)."""
    _require_dense(cfg)
    if ec.remat_policy not in ("none", "full"):
        raise ValueError(ec.remat_policy)

    def body(h, lp):
        return dense_block(lp, h, cfg, ec, positions, dt)

    for i in range(cfg.n_layers):
        lp = _layer(p["layers"], i)
        if ec.remat_policy == "full" and torch.is_grad_enabled():
            x = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x = body(x, lp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
