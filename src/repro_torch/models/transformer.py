"""Layer stacks of every architecture family: dense and vlm, moe, ssm
(Mamba1), hybrid (zamba2-style) and encdec.

Layer parameters are stacked with a leading L axis under `layers`, as in
the JAX package, so leaf paths and checkpoints match. A hybrid stack is
`{"shared": one dense block, "layers": Mamba2 blocks with lead (G,
attn_every), "tail": lead (n_layers % attn_every,)}`: each of the G groups
runs its Mamba2 layers, then the weight-shared dense block; the tail's
layers come last. (The reference simplifies Zamba2: no concatenated
embedding input, no per-application LoRA; the port copies the reference.)
A moe stack is the dense one with the MLP replaced by the routed
experts (`models.moe`); each layer returns its load-balancing loss, and
`stack_forward` sums them. An encdec stack is `{"enc_layers": dense
blocks with lead (n_enc_layers,), "layers": decoder blocks with lead
(n_layers,)}`, each decoder block self-attention, cross-attention over the
encoder output, then the MLP; the encoder (`encoder_forward`) is
bidirectional. A vlm stack is the dense one (the frontend is the model's
embedding, `Model._embed_inputs`). Where the reference scans over a
stacked axis, the port loops over it in Python; `remat_policy` "full"
recomputes each block in the backward pass through
`torch.utils.checkpoint`, a hybrid group as one block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import ModelConfig
from ..sharding.partition import recompute_context, shard_constraint
from ..tree import tree_map
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init

Params = Any


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution knobs. `attn_impl="pallas"` runs the port's kernels:
    prefill attention through F1 (a hybrid model's shared block, an
    encdec model's encoder and cross-attention too) and,
    in an ssm (Mamba1) model, the prefill scan through S1 (the reference's
    ssm path ignores the knob; ROADMAP C5). Mamba2 layers run the chunked
    SSD under every value, as in the reference. `seq_parallel` keeps the
    residual stream of a dense block sequence-sharded between its
    sublayers under a mesh (a no-op without one). `microbatches` is read
    by the dry run's train step alone (`launch/dryrun.py`: gradient
    accumulation), as in the reference. The reference's `scan_layers`
    has no counterpart: the port's layer loop is Python, so a trace of it
    is unrolled."""
    attn_impl: str = "chunked"        # naive | chunked | pallas (F1, S1)
    remat_policy: str = "full"        # none | full
    xent_chunks: int = 4
    microbatches: int = 1             # grad-accumulation inner loop
    seq_parallel: bool = False        # sequence-shard the residual stream
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
    def sp(t):
        # Megatron-style sequence parallelism: the residual stream lives
        # sequence-sharded between sublayers
        return shard_constraint(t, "batch", "seq", None) \
            if ec.seq_parallel else t

    h = sp(x + attn_mod.attention(p["attn"],
                                  rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                                  positions=positions, impl=ec.attn_impl,
                                  compute_dtype=dt))
    return sp(h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), dt))


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


def encdec_block_init(gen, cfg: ModelConfig, dtype, lead=()):
    return {
        "ln1": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "attn": attn_mod.attention_init(gen, cfg, dtype, lead),
        "ln_x": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "cross": attn_mod.attention_init(gen, cfg, dtype, lead),
        "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, cfg.mlp_gated,
                        lead),
    }


def encdec_block(p, x, enc_out, cfg: ModelConfig, ec: ExecConfig, positions,
                 dt):
    h = x + attn_mod.attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                               cfg, positions=positions, impl=ec.attn_impl,
                               compute_dtype=dt)
    h = h + attn_mod.attention(p["cross"], rmsnorm(p["ln_x"], h, cfg.norm_eps),
                               cfg, kv_input=enc_out, impl=ec.attn_impl,
                               compute_dtype=dt)
    return h + mlp(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps), dt)


def _hybrid_init(gen, cfg: ModelConfig, dtype):
    G, tail = divmod(cfg.n_layers, cfg.attn_every)
    p = {"shared": dense_block_init(gen, cfg, dtype),
         "layers": mamba_block_init(gen, cfg, dtype,
                                    lead=(G, cfg.attn_every))}
    if tail:
        p["tail"] = mamba_block_init(gen, cfg, dtype, lead=(tail,))
    return p


def _hybrid_forward(p, x, cfg, ec, positions, dt, enc_out):
    def group_body(h, gp):
        for i in range(cfg.attn_every):
            h = mamba_block(_layer(gp, i), h, cfg, dt)
        return dense_block(p["shared"], h, cfg, ec, positions, dt), None

    x, aux = _run_layers(group_body, x, p["layers"], ec)
    if "tail" in p:
        x, tail_aux = _run_layers(
            lambda h, lp: (mamba_block(lp, h, cfg, dt), None), x, p["tail"],
            ec)
        aux = aux + tail_aux
    return x, aux


def _hybrid_state(cfg, batch, max_len, dt, device):
    G, tail = divmod(cfg.n_layers, cfg.attn_every)
    state = {"mamba": mamba_mod.mamba_init_state(
        cfg, batch, torch.float32, device, lead=(G, cfg.attn_every))}
    if tail:
        state["tail"] = mamba_mod.mamba_init_state(
            cfg, batch, torch.float32, device, lead=(tail,))
    state["attn"] = attn_mod.init_kv_cache(cfg, batch, max_len, G, dt,
                                           device)
    return state


def _encdec_init(gen, cfg: ModelConfig, dtype):
    return {"enc_layers": dense_block_init(gen, cfg, dtype,
                                           lead=(cfg.n_enc_layers,)),
            "layers": encdec_block_init(gen, cfg, dtype,
                                        lead=(cfg.n_layers,))}


def _encdec_body(lp, h, cfg, ec, positions, dt, enc_out):
    if enc_out is None:
        raise ValueError("an encdec stack needs the encoder's output")
    return encdec_block(lp, h, enc_out, cfg, ec, positions, dt), None


def _dense_body(lp, h, cfg, ec, positions, dt, enc_out):
    return dense_block(lp, h, cfg, ec, positions, dt), None


def _moe_body(lp, h, cfg, ec, positions, dt, enc_out):
    return moe_block(lp, h, cfg, ec, positions, dt)


def _mamba_body(lp, h, cfg, ec, positions, dt, enc_out):
    return mamba_block(lp, h, cfg, dt), None


def _encdec_state(cfg, batch, max_len, dt, device):
    state = _kv_state(cfg, batch, max_len, dt, device)
    cross = attn_mod.init_kv_cache(cfg, batch, cfg.enc_seq_len,
                                   cfg.n_layers, dt, device)
    return dict(state, cross_k=cross["k"], cross_v=cross["v"])


def _layers_init(block_init):
    return lambda gen, cfg, dtype: {
        "layers": block_init(gen, cfg, dtype, lead=(cfg.n_layers,))}


def _layers_forward(body):
    """A stack of `layers` run one block at a time by `body(lp, h, cfg, ec,
    positions, dt, enc_out) -> (h, aux or None)`."""
    def forward(p, x, cfg, ec, positions, dt, enc_out):
        return _run_layers(
            lambda h, lp: body(lp, h, cfg, ec, positions, dt, enc_out),
            x, p["layers"], ec)
    return forward


def _kv_state(cfg, batch, max_len, dt, device):
    return attn_mod.init_kv_cache(cfg, batch, max_len, cfg.n_layers, dt,
                                  device)


def _ssm_state(cfg, batch, max_len, dt, device):
    return mamba_mod.mamba_init_state(cfg, batch, torch.float32, device,
                                      lead=(cfg.n_layers,))


def _kv_axes(lead: int = 1) -> dict:
    ax = (None,) * lead + ("batch", "kv_seq", "kv_heads", None)
    return {"k": ax, "v": ax}


def _encdec_axes(cfg) -> dict:
    cross = (None, "batch", None, "kv_heads", None)
    return dict(_kv_axes(), cross_k=cross, cross_v=cross)


def _ssm_axes(cfg, lead: int = 1) -> dict:
    lead = (None,) * lead
    h = ("batch", "heads", None) if cfg.ssm_version == 1 \
        else ("batch", "heads", None, None)
    return {"h": lead + h, "conv": lead + ("batch", None, "heads")}


def _hybrid_axes(cfg) -> dict:
    out = {"mamba": _ssm_axes(cfg, 2), "attn": _kv_axes()}
    if cfg.n_layers % cfg.attn_every:
        out["tail"] = _ssm_axes(cfg)
    return out


@dataclasses.dataclass(frozen=True)
class Family:
    """One architecture family's stack and decode state.
    `init(gen, cfg, dtype)` draws `params["stack"]`; `forward(p, x, cfg,
    ec, positions, dt, enc_out) -> (x, aux)` runs it; `init_state(cfg,
    batch, max_len, dt, device)` builds the zeroed decode state (the one
    place its leaves are made: `decode_state_batch_axes` reads their batch
    axes off it); `state_axes(cfg)` names the logical axis of each dim of
    each state leaf, in a tree shaped like it (the decode state's
    sharding; `decode_state_axes` holds the two alike); `prefill_inputs`
    are the batch keys that the prefill needs."""
    init: Callable
    forward: Callable
    init_state: Callable
    state_axes: Callable
    prefill_inputs: tuple = ("tokens",)


FAMILIES = {
    "dense": Family(_layers_init(dense_block_init),
                    _layers_forward(_dense_body), _kv_state,
                    lambda cfg: _kv_axes()),
    "vlm": Family(_layers_init(dense_block_init),
                  _layers_forward(_dense_body), _kv_state,
                  lambda cfg: _kv_axes()),
    "moe": Family(_layers_init(moe_block_init), _layers_forward(_moe_body),
                  _kv_state, lambda cfg: _kv_axes()),
    "encdec": Family(_encdec_init, _layers_forward(_encdec_body),
                     _encdec_state, _encdec_axes, ("tokens", "enc_emb")),
    "ssm": Family(_layers_init(mamba_block_init),
                  _layers_forward(_mamba_body), _ssm_state, _ssm_axes),
    "hybrid": Family(_hybrid_init, _hybrid_forward, _hybrid_state,
                     _hybrid_axes),
}


def family(cfg: ModelConfig) -> Family:
    """cfg's family; ValueError for a family no table row names."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return FAMILIES[cfg.family]


def stack_init(gen, cfg: ModelConfig, dtype) -> Params:
    """Stacked layer params (leading L axis) of the family's stack."""
    return family(cfg).init(gen, cfg, dtype)


def decode_state_batch_axes(cfg: ModelConfig):
    """A tree shaped like the family's decode state whose leaves are the
    batch axis of each state leaf: the one axis that differs between the
    states of batch 1 and batch 2 (built on the meta device)."""
    init_state = family(cfg).init_state
    one, two = (init_state(cfg, b, 1, torch.float32, torch.device("meta"))
                for b in (1, 2))
    return tree_map(lambda a, b: next(
        i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n),
        one, two)


def decode_state_axes(cfg: ModelConfig, fn: Callable = lambda axes: axes):
    """`fn` of the family's `state_axes` of each decode-state leaf, in a
    tree shaped like the state, checked against the state it describes:
    the same leaves, one axis name per dim, "batch" at each leaf's batch
    axis (ValueError otherwise)."""
    axes = family(cfg).state_axes(cfg)
    state = family(cfg).init_state(cfg, 1, 1, torch.float32,
                                   torch.device("meta"))

    def one(s, a, b):
        if len(a) != s.dim() or a.index("batch") != b:
            raise ValueError(f"state_axes {a} of the {cfg.family} family "
                             f"do not describe a state leaf of rank "
                             f"{s.dim()} with batch axis {b}")
        return fn(a)

    return tree_map(one, state, axes, decode_state_batch_axes(cfg))


def _layer(layers, i: int):
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def _n_stacked(layers) -> int:
    """The length of the leading (stacked) axis of a tree of layers."""
    while isinstance(layers, dict):
        layers = next(iter(layers.values()))
    return layers.shape[0]


def _run_layers(body, x, layers, ec: ExecConfig):
    """x through each layer's `body(x, lp)` -> (x, aux or None): (x, the
    auxes summed in float32)."""
    if ec.remat_policy not in ("none", "full"):
        raise ValueError(ec.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_n_stacked(layers)):
        lp = _layer(layers, i)
        if ec.remat_policy == "full" and torch.is_grad_enabled():
            x, a = checkpoint(body, x, lp, use_reentrant=False,
                              context_fn=recompute_context)
        else:
            x, a = body(x, lp)
        if a is not None:
            aux = aux + a
    return x, aux


def stack_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  ec: ExecConfig, positions, dt, enc_out=None):
    """x: (B,S,D) -> ((B,S,D), aux_loss): the sum of the layers' MoE
    load-balancing losses in float32 (0 outside the moe family). An encdec
    stack's decoder cross-attends to `enc_out` (B,S_enc,D), the encoder's
    normed output."""
    return family(cfg).forward(p, x, cfg, ec, positions, dt, enc_out)


def encoder_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    ec: ExecConfig, dt) -> torch.Tensor:
    """The bidirectional encoder of an encdec stack: x (B,S_enc,D) through
    `enc_layers`, dense blocks whose attention is non-causal, with RoPE at
    positions 0..S_enc-1."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(h, lp):
        h2 = h + attn_mod.attention(
            lp["attn"], rmsnorm(lp["ln1"], h, cfg.norm_eps), cfg,
            positions=positions, causal=False, impl=ec.attn_impl,
            compute_dtype=dt)
        return h2 + mlp(lp["mlp"], rmsnorm(lp["ln2"], h2, cfg.norm_eps),
                        dt), None

    return _run_layers(body, x, p["enc_layers"], ec)[0]
