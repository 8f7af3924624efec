"""Config dataclasses (counterpart of ``repro.configs.base``).

``DiTConfig`` covers the paper's diffusion-transformer denoisers;
``ModelConfig`` the assigned LM families: dense, MoE, SSM, hybrid,
enc-dec (audio) and modality-prefix (vlm).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    every: int = 1
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    # dispatch: "einsum" (GShard one-hot products) or "gather" (slot
    # indices)
    impl: str = "einsum"
    # never-routed experts appended so the expert count divides a mesh
    # axis
    padded_experts: int = 0

    @property
    def e_total(self) -> int:
        return max(self.n_experts, self.padded_experts)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # hybrid: one attention layer per group
    is_encdec: bool = False
    n_enc_layers: int = 0
    n_prefix_tokens: int = 0
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 500000.0
    use_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    source: str = ""                 # citation for the config

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        ssm = self.ssm or SSMConfig()
        return ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        ssm = self.ssm or SSMConfig()
        return self.d_inner // ssm.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds ('attn' | 'ssm'), length n_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.family == "hybrid" and self.attn_every > 0:
            return tuple("attn" if i % self.attn_every == self.attn_every - 1
                         else "ssm" for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None or self.moe.n_experts == 0:
            return False
        return (layer_idx % self.moe.every) == (self.moe.every - 1)


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
