"""Zamba2-7B — Mamba2 backbone + weight-shared attention block applied
every 6 mamba layers [arXiv:2411.15242; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_version=2, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    attn_every=6,
)
