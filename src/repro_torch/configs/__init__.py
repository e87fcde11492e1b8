"""Config registry: --arch <id> -> ModelConfig (+ reduced smoke variants)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES, shape_applicable

from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .granite_20b import CONFIG as granite_20b
from .qwen3_32b import CONFIG as qwen3_32b
from .yi_34b import CONFIG as yi_34b
from .qwen2_7b import CONFIG as qwen2_7b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .zamba2_7b import CONFIG as zamba2_7b
from .llava_next_34b import CONFIG as llava_next_34b
from .paper_demo import CONFIG as paper_demo

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        olmoe_1b_7b, qwen3_moe_30b_a3b, falcon_mamba_7b, granite_20b,
        qwen3_32b, yi_34b, qwen2_7b, seamless_m4t_medium, zamba2_7b,
        llava_next_34b, paper_demo,
    ]
}

ASSIGNED = [n for n in ARCHS if n != "paper-demo"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: few layers, narrow
    width, small vocab/experts — exercises every code path of the family."""
    kw = dict(
        n_layers=max(2, (cfg.attn_every or 0) + 1) if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm_chunk=16,
    )
    if cfg.is_moe:
        kw.update(n_experts=4, experts_per_token=2, d_ff=32)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_head_dim=16)
    if cfg.family == "hybrid":
        kw.update(attn_every=2, n_layers=5)      # 2 groups + tail of 1
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq_len=16)
    if cfg.family == "vlm":
        kw.update(n_frontend_tokens=8)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)


__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "get_config", "reduced",
           "ModelConfig", "ShapeConfig", "shape_applicable"]
