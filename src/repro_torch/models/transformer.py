"""Layer stacks of the dense, moe, ssm (Mamba1) and hybrid (zamba2-style)
families.

Layer parameters are stacked with a leading L axis under `layers`, as in
the JAX package, so leaf paths and checkpoints match. A hybrid stack is
`{"shared": one dense block, "layers": Mamba2 blocks with lead (G,
attn_every), "tail": lead (n_layers % attn_every,)}`: each of the G groups
runs its Mamba2 layers, then the weight-shared dense block; the tail's
layers come last. (The reference simplifies Zamba2: no concatenated
embedding input, no per-application LoRA; the port copies the reference.)
A moe stack is the dense one with the MLP replaced by the routed
experts (`models.moe`); each layer returns its load-balancing loss, and
`stack_forward` sums them. Where the reference scans over a stacked axis,
the port loops over it in Python; `remat_policy` "full" recomputes each
block in the backward pass through `torch.utils.checkpoint`, a hybrid
group as one block.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init

Params = Any


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs. `attn_impl="pallas"` runs the port's kernels:
    prefill attention through F1 (a hybrid model's shared block too) and,
    in an ssm (Mamba1) model, the prefill scan through S1 (the reference's
    ssm path ignores the knob; ROADMAP C5). Mamba2 layers run the chunked
    SSD under every value, as in the reference."""
    attn_impl: str = "chunked"        # naive | chunked | pallas (F1, S1)
    remat_policy: str = "full"        # none | full
    xent_chunks: int = 4
    moe_group: int = 256              # MoE routing group size (tokens)


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


def moe_block_init(gen, cfg: ModelConfig, dtype, lead=()):
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "attn": attn_mod.attention_init(gen, cfg, dtype, lead),
        "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "moe": moe_mod.moe_init(gen, cfg, dtype, lead),
    }


def moe_block(p, x, cfg: ModelConfig, ec: ExecConfig, positions, dt):
    """-> (x, the layer's load-balancing loss)."""
    h = x + attn_mod.attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg, positions=positions, impl=ec.attn_impl,
                               compute_dtype=dt)
    y, aux = moe_mod.moe_mlp(p["moe"], rmsnorm(p["ln2"], h, cfg.norm_eps),
                             cfg, dt, group_size=ec.moe_group)
    return h + y, aux


def mamba_block_init(gen, cfg: ModelConfig, dtype, lead=()):
    return {
        "ln": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "mamba": mamba_mod.mamba_init(gen, cfg, dtype, lead),
    }


def mamba_block(p, x, cfg: ModelConfig, dt):
    return x + mamba_mod.mamba_forward(
        p["mamba"], rmsnorm(p["ln"], x, cfg.norm_eps), cfg, dt)


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _require_ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: only "
            f"{PORTED_FAMILIES} are (ROADMAP queue A, item 6)")


def stack_init(gen, cfg: ModelConfig, dtype) -> Params:
    """Stacked layer params (leading L axis) of the decoder stack."""
    _require_ported(cfg)
    if cfg.family == "hybrid":
        G, tail = divmod(cfg.n_layers, cfg.attn_every)
        p = {"shared": dense_block_init(gen, cfg, dtype),
             "layers": mamba_block_init(gen, cfg, dtype,
                                        lead=(G, cfg.attn_every))}
        if tail:
            p["tail"] = mamba_block_init(gen, cfg, dtype, lead=(tail,))
        return p
    init = {"ssm": mamba_block_init, "moe": moe_block_init}.get(
        cfg.family, dense_block_init)
    return {"layers": init(gen, cfg, dtype, lead=(cfg.n_layers,))}


def _layer(layers, i: int):
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _n_stacked(layers) -> int:
    """The length of the leading (stacked) axis of a tree of layers."""
    while isinstance(layers, dict):
        layers = next(iter(layers.values()))
    return layers.shape[0]


def stack_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  ec: ExecConfig, positions, dt):
    """x: (B,S,D) -> ((B,S,D), aux_loss): the sum of the layers' MoE
    load-balancing losses in float32 (0 outside the moe family)."""
    _require_ported(cfg)
    if ec.remat_policy not in ("none", "full"):
        raise ValueError(ec.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(body, x, layers):
        """Each layer's `body(x, lp)` -> (x, aux), aux summed."""
        nonlocal aux
        for i in range(_n_stacked(layers)):
            lp = _layer(layers, i)
            if ec.remat_policy == "full" and torch.is_grad_enabled():
                x, a = checkpoint(body, x, lp, use_reentrant=False)
            else:
                x, a = body(x, lp)
            aux = aux + a
        return x

    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def mamba_body(h, lp):
        return mamba_block(lp, h, cfg, dt), zero

    if cfg.family == "hybrid":
        def group_body(h, gp):
            for i in range(cfg.attn_every):
                h = mamba_block(_layer(gp, i), h, cfg, dt)
            return dense_block(p["shared"], h, cfg, ec, positions, dt), zero

        x = run(group_body, x, p["layers"])
        if "tail" in p:
            x = run(mamba_body, x, p["tail"])
    elif cfg.family == "ssm":
        x = run(mamba_body, x, p["layers"])
    elif cfg.family == "moe":
        x = run(lambda h, lp: moe_block(lp, h, cfg, ec, positions, dt), x,
                p["layers"])
    else:
        x = run(lambda h, lp: (dense_block(lp, h, cfg, ec, positions, dt),
                               zero), x, p["layers"])
    return x, aux
