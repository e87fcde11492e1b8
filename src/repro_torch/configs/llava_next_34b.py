"""LLaVA-NeXT-34B — Yi-34B backbone; anyres vision frontend stubbed as
precomputed patch embeddings via input_specs()
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    frontend="vision", n_frontend_tokens=2880,
)
