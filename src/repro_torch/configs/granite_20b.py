"""Granite-20B (code) — llama-arch MQA (kv=1) [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128, mlp_gated=False,
)
