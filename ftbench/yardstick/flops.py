"""Analytic FLOPs, frozen from `repro_torch/models/flops.py` (the same
arithmetic; a matmul (M,K)x(K,N) costs 2·M·K·N), and the serving path's
model FLOPs built from them.

`Sizes` reads a configuration file of `ftbench/configs/` (the port's
`ModelConfig` keys), so the yardstick needs nothing of the program.
"""
from __future__ import annotations


class Sizes:
    """The sizes of one configuration file, with the derived ones
    (`head_dim`, `d_inner`, `n_ssm_heads`) as the port derives them."""

    def __init__(self, cfg: dict):
        self.__dict__.update(cfg)
        if not cfg.get("head_dim") and cfg.get("n_heads"):
            self.head_dim = cfg["d_model"] // cfg["n_heads"]
        self.d_inner = cfg.get("ssm_expand", 2) * cfg["d_model"]
        if cfg.get("ssm_head_dim"):
            self.n_ssm_heads = self.d_inner // cfg["ssm_head_dim"]


# ------------------------------------------------- frozen from flops.py

def attn_flops(cfg, B: int, Sq: int, Sk: int, *, causal: bool,
               flash: bool) -> float:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * B * Sq * D * (H * hd)            # q
    proj += 2 * 2 * B * Sk * D * (Hkv * hd)     # k, v (projected from Sk)
    proj += 2 * B * Sq * (H * hd) * D           # o
    core = 2 * 2 * B * H * Sq * Sk * hd         # scores + AV
    if causal and flash and Sq == Sk:
        core *= 0.5
    return proj + core


def mlp_flops(cfg, B: int, S: int) -> float:
    m = 3 if cfg.mlp_gated else 2
    return m * 2 * B * S * cfg.d_model * cfg.d_ff


def moe_flops(cfg, B: int, S: int, group: int = 512) -> float:
    T = B * S
    E, k, D, F = cfg.n_experts, cfg.experts_per_token, cfg.d_model, cfg.d_ff
    g = min(group, T)
    cap = max(int(cfg.capacity_factor * k * g / E), 4)
    router = 2 * T * D * E
    dispatch = 2 * 2 * T * E * cap * D
    experts = 3 * 2 * (T // g * E * cap) * D * F
    return router + dispatch + experts


def mamba_flops(cfg, B: int, S: int) -> float:
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


def forward_flops(cfg, B: int, S: int, *, flash: bool = False,
                  moe_group: int = 512) -> float:
    """One forward of the decoder stack and the unembedding of every
    position (dense, vlm, moe and ssm families)."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        per = attn_flops(cfg, B, S, S, causal=True, flash=flash) \
            + mlp_flops(cfg, B, S)
    elif fam == "moe":
        per = attn_flops(cfg, B, S, S, causal=True, flash=flash) \
            + moe_flops(cfg, B, S, group=moe_group)
    elif fam == "ssm":
        per = mamba_flops(cfg, B, S)
    else:
        raise ValueError(fam)
    return cfg.n_layers * per + 2 * B * S * cfg.d_model * cfg.vocab_size


def decode_flops(cfg, B: int, Sk: int) -> float:
    """One-token decode against a Sk-long state (dense, vlm, moe, ssm)."""
    fam, D = cfg.family, cfg.d_model

    def attn_decode():
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        return 2 * B * D * (H + 2 * Hkv) * hd + 2 * B * (H * hd) * D \
            + 2 * 2 * B * H * Sk * hd

    if fam in ("dense", "vlm"):
        per = attn_decode() + (3 if cfg.mlp_gated else 2) * 2 * B * D \
            * cfg.d_ff
    elif fam == "moe":
        per = attn_decode() + moe_flops(cfg, B, 1)
    elif fam == "ssm":
        per = mamba_flops(cfg, B, 1)
    else:
        raise ValueError(fam)
    return cfg.n_layers * per + 2 * B * D * cfg.vocab_size


# ------------------------------------------- the serving path's model FLOPs

def _moe_model_flops(cfg, T: int) -> float:
    """The router and the k experts each token needs: the work of the
    layer's mathematics, not of the dense dispatch that computes it."""
    D = cfg.d_model
    return 2 * T * D * cfg.n_experts \
        + 3 * 2 * T * cfg.experts_per_token * D * cfg.d_ff


def prefill_model_flops(cfg, S: int) -> float:
    """The model FLOPs of one prompt of S tokens: the stack over every
    position (causal attention counted once a pair) and the unembedding of
    the last position, which is all the prefill unembeds."""
    fam = cfg.family
    if fam == "moe":
        per = attn_flops(cfg, 1, S, S, causal=True, flash=True) \
            + _moe_model_flops(cfg, S)
    elif fam in ("dense", "vlm"):
        per = attn_flops(cfg, 1, S, S, causal=True, flash=True) \
            + mlp_flops(cfg, 1, S)
    elif fam == "ssm":
        per = mamba_flops(cfg, 1, S)
    else:
        raise ValueError(fam)
    return cfg.n_layers * per + 2 * cfg.d_model * cfg.vocab_size


def decode_model_flops(cfg, pos: int) -> float:
    """The model FLOPs of one decoded token at position `pos` (the keys
    0..pos attended)."""
    fam = cfg.family
    if fam == "moe":
        H, Hkv, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
        per = 2 * D * (H + 2 * Hkv) * hd + 2 * (H * hd) * D \
            + 2 * 2 * H * (pos + 1) * hd + _moe_model_flops(cfg, 1)
        return cfg.n_layers * per + 2 * D * cfg.vocab_size
    if fam == "ssm":
        return decode_flops(cfg, 1, pos + 1)
    raise ValueError(fam)
