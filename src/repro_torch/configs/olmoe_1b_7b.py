"""OLMoE-1B-7B — MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, experts_per_token=8,
)
