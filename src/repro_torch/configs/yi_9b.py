"""Yi-9B — llama-arch dense GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab_size=64000, head_dim=128,
    source="llama-arch GQA [arXiv:2403.04652]",
)
