"""Jamba-1.5-Large 398B — Mamba+attention 1:7 interleave, MoE 16 experts
top-2 [arXiv:2403.19887]: 72 layers in 9 groups of 7 Mamba2 layers and 1
attention layer, the MoE FFN on every other layer."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536, head_dim=128, attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, every=2),
    ssm=SSMConfig(d_state=128, head_dim=128, expand=2, chunk=256),
    source="Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887]",
)
