"""SeamlessM4T-medium — enc-dec multimodal speech backbone
[arXiv:2308.11596].  The audio frontend (mel + conv feature extractor)
is a stub: the encoder takes precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=256206, head_dim=64,
    is_encdec=True, n_enc_layers=12,
    source="enc-dec, multimodal [arXiv:2308.11596]",
)
