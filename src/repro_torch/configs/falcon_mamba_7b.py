"""Falcon-Mamba-7B — attention-free Mamba1 [arXiv:2410.05355; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_version=1, ssm_expand=2, ssm_conv=4,
)
