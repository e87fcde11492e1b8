"""Model configuration for all assigned architecture families.

A single frozen dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM
families; family-specific fields default to "off". Configs are pure data so
they can be hashed into jit static args and serialized into checkpoints.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_gated: bool = True      # False -> 2-matmul (up, down) MLP
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE (d_ff is the per-expert width for moe archs)
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64      # mamba2 only
    ssm_version: int = 1        # 1 = selective scan, 2 = SSD
    ssm_chunk: int = 128        # chunked-scan block length

    # hybrid (zamba2-style): a weight-shared attention block applied after
    # every `attn_every` mamba layers.
    attn_every: int = 0

    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq_len: int = 0        # fixed encoder context for decode shapes

    # modality frontend stub: embeddings are provided by input_specs()
    frontend: Optional[str] = None   # "vision" | "audio"
    n_frontend_tokens: int = 0

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports very long context decode (O(1)-ish state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- parameter counting (used for MODEL_FLOPS = 6 N D) -----
    def _attn_params(self) -> int:
        hd = self.head_dim
        p = self.d_model * (self.n_heads * hd)            # q
        p += 2 * self.d_model * (self.n_kv_heads * hd)    # k, v
        p += (self.n_heads * hd) * self.d_model           # o
        if self.qkv_bias:
            p += (self.n_heads + 2 * self.n_kv_heads) * hd
        return p

    def _mlp_params(self) -> int:
        m = 3 if self.mlp_gated else 2
        return m * self.d_model * self.d_ff               # (gate,) up, down

    def _moe_params(self, active_only: bool) -> int:
        e = self.experts_per_token if active_only else self.n_experts
        return self.d_model * self.n_experts + e * 3 * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        di, ds = self.d_inner, self.ssm_state
        p = self.d_model * 2 * di                          # in_proj (x, z)
        p += self.ssm_conv * di                            # depthwise conv
        p += di * self.d_model                             # out_proj
        if self.ssm_version == 1:
            dt_rank = max(self.d_model // 16, 1)
            p += di * (dt_rank + 2 * ds) + dt_rank * di    # x_proj, dt_proj
            p += di * ds + di                              # A_log, D
        else:  # mamba2 / SSD
            nh = self.n_ssm_heads
            p += self.d_model * (2 * ds + nh)              # B, C, dt projections
            p += nh + nh + di                              # A_log, D, norm
        return p

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts routed experts only."""
        emb = self.vocab_size * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        if self.frontend:
            total += self.d_model  # stub projection scale only

        def block_dense():
            return self._attn_params() + self._mlp_params() + 2 * self.d_model

        if self.family in ("dense", "vlm"):
            total += self.n_layers * block_dense()
        elif self.family == "moe":
            per = self._attn_params() + self._moe_params(active_only) + 2 * self.d_model
            total += self.n_layers * per
        elif self.family == "ssm":
            total += self.n_layers * (self._mamba_params() + self.d_model)
        elif self.family == "hybrid":
            total += self.n_layers * (self._mamba_params() + self.d_model)
            total += block_dense()                         # one shared attn block
        elif self.family == "encdec":
            # encoder: self-attn + mlp; decoder: self + cross + mlp
            enc = self.n_enc_layers * (self._attn_params() + self._mlp_params()
                                       + 2 * self.d_model)
            dec = self.n_layers * (2 * self._attn_params() + self._mlp_params()
                                   + 3 * self.d_model)
            total += enc + dec
        else:
            raise ValueError(f"unknown family {self.family}")
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode skipped (DESIGN.md §4)"
    return True, ""
