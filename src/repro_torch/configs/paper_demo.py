"""Paper-demo config: ~100M-parameter dense LM used by the end-to-end
fault-tolerance examples/benchmarks (the HPC-proxy-app analogue)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-demo", family="dense",
    n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=32768, head_dim=64,
)
