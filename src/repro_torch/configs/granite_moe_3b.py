"""Granite-MoE 3B (800M active) — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8, every=1),
    tie_embeddings=True,
    source="40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]",
)
