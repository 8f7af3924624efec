"""FLUX.1-dev-like MMDiT — the paper's primary model [Labs 2024].

19 dual-stream (image+text) blocks + 38 single-stream blocks, d=3072,
16-channel latents — the FreqCa paper's L=57 cached-feature count.
"""
from repro_torch.configs.base import DiTConfig

CONFIG = DiTConfig(
    arch_id="flux1-dev", n_layers=38, n_double=19, d_model=3072,
    n_heads=24, d_ff=12288, patch_size=2, in_channels=16,
    text_dim=4096, n_text_tokens=512, dtype="bfloat16",
    source="FLUX.1-dev [github.com/black-forest-labs/flux]",
)
