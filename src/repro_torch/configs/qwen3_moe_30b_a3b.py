"""Qwen3-MoE-30B-A3B — MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128, qk_norm=True,
    n_experts=128, experts_per_token=8,
)
