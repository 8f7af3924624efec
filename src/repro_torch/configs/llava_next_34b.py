"""LLaVA-NeXT 34B — VLM language decoder; anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf family].  The vision frontend
(SigLIP/ViT + projector, anyres tiling) is a stub: 2880 precomputed
patch embeddings (576 base + 4 tiles x 576) are projected and prepended
to the text tokens."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128, n_prefix_tokens=2880,
    source="anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf]",
)
