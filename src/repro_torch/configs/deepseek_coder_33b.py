"""DeepSeek-Coder-33B — llama-arch dense GQA [arXiv:2401.14196]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab_size=32256, head_dim=128, rope_theta=100000.0,
    source="llama-arch [arXiv:2401.14196]",
)
