"""Diffusion-transformer config (counterpart of ``repro.configs.base``).

Only the DiT family is ported in this slice; the LM ``ModelConfig``
family comes with the LM backbones.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Diffusion-transformer denoiser (the paper's model family).

    FLUX-like MMDiT: ``n_double`` joint (text+image dual-stream) blocks
    then ``n_layers`` single-stream blocks; ``n_double == 0`` is a plain
    DiT.
    """
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    patch_size: int = 2
    in_channels: int = 4
    n_double: int = 0
    text_dim: int = 0
    n_text_tokens: int = 0
    time_embed_dim: int = 256
    norm_eps: float = 1e-6
    dtype: str = "float32"
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads
