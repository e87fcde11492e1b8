"""Analytic FLOP / HBM-byte model per (arch × shape) cell.

A copy of the JAX package's `models/flops.py`, the same arithmetic; the
notes below are the reference's. In the port the traced counterpart of
XLA's cost_analysis and HLO is `launch/trace_analysis.py`, and F1 and S1
are counted by the formulas of `attn_flops` (flash) and `mamba_flops`.

Why analytic: XLA's cost_analysis() counts scan bodies once (validated in
tests/test_roofline_model.py) and reports per-device numbers after fusion,
so the roofline harness uses an explicit count of the model's matmul-level
work, *validated against cost_analysis on small unrolled configs*, plus the
compiled HLO for the collective schedule (launch/hlo_analysis.py corrects
while-body trip counts there).

Conventions:
  - FLOPs are totals across the mesh for ONE step of the cell's kind
    (train_step / prefill / decode_step); divide by chips for per-chip.
  - A matmul (M,K)x(K,N) costs 2·M·K·N.
  - Train = 3× forward matmul FLOPs (fwd + 2× bwd) + remat recompute
    (= +1× fwd for the layer stack under the "full" policy).
  - Causal attention counts the full S² unless `flash=True` (the Pallas
    kernel skips above-diagonal blocks → ×0.5): the baseline chunked-jnp
    lowering really does compute the full square.
  - HBM bytes are a fusion-level estimate with documented multipliers —
    good for term dominance, not for ±5% accuracy.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class CellCost:
    flops: float                  # total FLOPs / step across the mesh
    hbm_bytes: float              # total HBM traffic / step across mesh
    details: dict

    def per_chip(self, chips: int) -> tuple[float, float]:
        return self.flops / chips, self.hbm_bytes / chips


def _bytes_of(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]


# --------------------------------------------------------------- attention

def attn_flops(cfg: ModelConfig, B: int, Sq: int, Sk: int, *,
               causal: bool, flash: bool) -> float:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * B * Sq * D * (H * hd)            # q
    proj += 2 * 2 * B * Sk * D * (Hkv * hd)     # k, v (projected from Sk)
    proj += 2 * B * Sq * (H * hd) * D           # o
    core = 2 * 2 * B * H * Sq * Sk * hd         # scores + AV
    if causal and flash and Sq == Sk:
        core *= 0.5
    return proj + core


def mlp_flops(cfg: ModelConfig, B: int, S: int) -> float:
    m = 3 if cfg.mlp_gated else 2
    return m * 2 * B * S * cfg.d_model * cfg.d_ff


def moe_flops(cfg: ModelConfig, B: int, S: int, group: int = 512) -> float:
    T = B * S
    E, k, D, F = cfg.n_experts, cfg.experts_per_token, cfg.d_model, cfg.d_ff
    g = min(group, T)
    cap = max(int(cfg.capacity_factor * k * g / E), 4)
    router = 2 * T * D * E
    # dispatch + combine one-hot einsums (GShard formulation cost)
    dispatch = 2 * 2 * T * E * cap * D
    experts = 3 * 2 * (T // g * E * cap) * D * F
    return router + dispatch + experts


def mamba_flops(cfg: ModelConfig, B: int, S: int) -> float:
    D, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    f = 2 * B * S * D * 2 * di                  # in_proj
    f += 2 * cfg.ssm_conv * B * S * di          # depthwise conv
    f += 2 * B * S * di * D                     # out_proj
    if cfg.ssm_version == 1:
        dtr = max(D // 16, 1)
        f += 2 * B * S * di * (dtr + 2 * ds)    # x_proj
        f += 2 * B * S * dtr * di               # dt_proj
        f += 8 * B * S * di * ds                # scan: dA, dBx, h, y
    else:
        nh, hp, c = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
        c = min(c, S)
        f += 2 * B * S * c * ds                 # G = C·Bᵀ per chunk
        f += 2 * B * nh * S * c * hp            # M @ x (intra-chunk)
        f += 4 * B * S * nh * hp * ds           # state update + off-diag
    return f


def _block_flops(cfg: ModelConfig, B: int, S: int, *, flash: bool,
                 moe_group: int = 512) -> float:
    """One decoder layer, forward."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return attn_flops(cfg, B, S, S, causal=True, flash=flash) \
            + mlp_flops(cfg, B, S)
    if fam == "moe":
        return attn_flops(cfg, B, S, S, causal=True, flash=flash) \
            + moe_flops(cfg, B, S, group=moe_group)
    if fam == "ssm":
        return mamba_flops(cfg, B, S)
    if fam == "hybrid":
        # per mamba layer; the shared attn block is charged per group
        return mamba_flops(cfg, B, S)
    if fam == "encdec":
        return 2 * attn_flops(cfg, B, S, S, causal=True, flash=flash) \
            + mlp_flops(cfg, B, S)     # self + cross (approx: Sk=S)
    raise ValueError(fam)


def forward_flops(cfg: ModelConfig, B: int, S: int, *,
                  flash: bool = False, moe_group: int = 512) -> float:
    f = cfg.n_layers * _block_flops(cfg, B, S, flash=flash,
                                    moe_group=moe_group)
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        f += G * (attn_flops(cfg, B, S, S, causal=True, flash=flash)
                  + mlp_flops(cfg, B, S))
    if cfg.family == "encdec":
        f += cfg.n_enc_layers * (
            attn_flops(cfg, B, cfg.enc_seq_len, cfg.enc_seq_len,
                       causal=False, flash=flash)
            + mlp_flops(cfg, B, cfg.enc_seq_len))
    f += 2 * B * S * cfg.d_model * cfg.vocab_size      # unembed logits
    return f


def decode_flops(cfg: ModelConfig, B: int, Sk: int, *,
                 flash: bool = False) -> float:
    """One-token decode against a Sk-long state."""
    fam = cfg.family
    D = cfg.d_model

    def attn_decode():
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        proj = 2 * B * D * (H + 2 * Hkv) * hd + 2 * B * (H * hd) * D
        core = 2 * 2 * B * H * Sk * hd
        return proj + core

    def mlp_dec():
        return (3 if cfg.mlp_gated else 2) * 2 * B * D * cfg.d_ff

    if fam in ("dense", "vlm"):
        per = attn_decode() + mlp_dec()
    elif fam == "moe":
        per = attn_decode() + moe_flops(cfg, B, 1)
    elif fam == "ssm":
        per = mamba_flops(cfg, B, 1)
    elif fam == "hybrid":
        per = mamba_flops(cfg, B, 1)
    elif fam == "encdec":
        # self-attn decode + cross-attn over enc_seq_len + mlp
        H, hd = cfg.n_heads, cfg.head_dim
        cross = 2 * 2 * B * H * cfg.enc_seq_len * hd \
            + 2 * B * D * H * hd * 2
        per = attn_decode() + cross + mlp_dec()
    else:
        raise ValueError(fam)
    f = cfg.n_layers * per
    if fam == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        shared = 2 * B * D * (H + 2 * Hkv) * hd + 2 * B * (H * hd) * D \
            + 2 * 2 * B * H * Sk * hd + mlp_dec()
        f += G * shared
    f += 2 * B * D * cfg.vocab_size
    return f


# ------------------------------------------------------------------ bytes

def kv_cache_bytes(cfg: ModelConfig, B: int, Smax: int) -> float:
    """Device-resident decode state size (bf16 KV / fp32 SSM)."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "encdec"):
        per_layer = 2 * B * Smax * cfg.n_kv_heads * cfg.head_dim * 2
        total = cfg.n_layers * per_layer
        if fam == "encdec":
            total += cfg.n_layers * 2 * B * cfg.enc_seq_len * \
                cfg.n_kv_heads * cfg.head_dim * 2
        return total
    ssm = cfg.n_layers * B * 4 * (
        (cfg.d_inner * cfg.ssm_state if cfg.ssm_version == 1
         else cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state)
        + (cfg.ssm_conv - 1) * (cfg.d_inner if cfg.ssm_version == 1
                                else cfg.d_inner + 2 * cfg.ssm_state))
    if fam == "hybrid":
        G = cfg.n_layers // cfg.attn_every
        ssm += G * 2 * B * Smax * cfg.n_kv_heads * cfg.head_dim * 2
    return ssm


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, *,
              flash: bool = False, remat: bool = True,
              moe_group: int = 512) -> CellCost:
    """Roofline terms for one step of this cell (totals across the mesh)."""
    B, S = shape.global_batch, shape.seq_len
    P = cfg.param_count()
    P_active = cfg.param_count(active_only=True)
    pbytes = _bytes_of(cfg.param_dtype)
    d = {}

    if shape.kind == "train":
        fwd = forward_flops(cfg, B, S, flash=flash, moe_group=moe_group)
        flops = 3 * fwd
        if remat:
            # recompute the layer stack (not the unembed) in backward
            flops += fwd - 2 * B * S * cfg.d_model * cfg.vocab_size
        # params: fwd read + bwd read + grad write + Adam m/v r+w + p write
        param_traffic = P * pbytes * 2 + P * 4 * (1 + 4 + 1)
        # activations (full remat): store+read one (B,S,D) per layer in bf16
        act = 4 * cfg.n_layers * B * S * cfg.d_model * 2
        # within-layer traffic: x/out plus ff/kv intermediates ≈ 8×(B,S,D)
        act += 8 * cfg.n_layers * B * S * cfg.d_model * 2 * (2 if remat else 1)
        logits = 2 * B * S * cfg.vocab_size * 2 / 8        # chunked
        hbm = param_traffic + act + logits
        d = {"fwd_flops": fwd, "param_traffic": param_traffic, "act": act}

    elif shape.kind == "prefill":
        flops = forward_flops(cfg, B, S, flash=flash, moe_group=moe_group)
        act = 10 * cfg.n_layers * B * S * cfg.d_model * 2
        hbm = P * pbytes + act + kv_cache_bytes(cfg, B, S)
        d = {"kv_write": kv_cache_bytes(cfg, B, S)}

    else:  # decode
        flops = decode_flops(cfg, B, S, flash=flash)
        state = kv_cache_bytes(cfg, B, S)
        # decode reads all params + the full state once per token
        hbm = P * pbytes + state + B * cfg.d_model * cfg.n_layers * 2 * 10
        d = {"state_bytes": state}

    d["model_flops"] = (6 * P_active * B * S if shape.kind == "train"
                        else 2 * P_active * B * (S if shape.kind == "prefill"
                                                 else 1))
    return CellCost(flops=float(flops), hbm_bytes=float(hbm), details=d)
