"""Mamba2-370m — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab_size=50280, head_dim=64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
    source="SSD (state-space duality) [arXiv:2405.21060]",
)
