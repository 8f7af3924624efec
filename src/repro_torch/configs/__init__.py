"""Architecture registry of the port: the DiT configs and the twelve
assigned LM configs (the dense ``yi-9b``, ``deepseek-coder-33b``,
``llama3-405b`` and ``command-r-plus-104b``, the MoE
``granite-moe-3b-a800m`` and ``phi3.5-moe-42b-a6.6b``, the SSM
``mamba2-370m``, the hybrid ``jamba-1.5-large-398b``, the enc-dec
``seamless-m4t-medium`` and the modality-prefix ``llava-next-34b``), and
the assigned input shapes with the config variant each runs."""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

from repro_torch.configs import (command_r_plus_104b, deepseek_coder_33b,
                                 dit_small, flux1_dev, granite_moe_3b,
                                 jamba_15_large, llama3_405b, llava_next_34b,
                                 mamba2_370m, phi35_moe_42b,
                                 seamless_m4t_medium, yi_9b)
from repro_torch.configs.base import DiTConfig, ModelConfig

# in the reference's order, so that ``list_archs`` lists as it does
REGISTRY: Dict[str, Union[ModelConfig, DiTConfig]] = {
    m.CONFIG.arch_id: m.CONFIG
    for m in (mamba2_370m, deepseek_coder_33b, seamless_m4t_medium,
              phi35_moe_42b, granite_moe_3b, llama3_405b, yi_9b,
              jamba_15_large, command_r_plus_104b, llava_next_34b,
              dit_small, flux1_dev)
}

# the ten assigned LM architectures, the reference's dry-run targets
ASSIGNED = [
    "mamba2-370m", "deepseek-coder-33b", "seamless-m4t-medium",
    "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "llama3-405b",
    "yi-9b", "jamba-1.5-large-398b", "command-r-plus-104b",
    "llava-next-34b",
]

INPUT_SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32,
                    "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128,
                   "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

# window of the sliding-window variant that pure full-attention
# architectures run at long_500k
LONG_CONTEXT_WINDOW = 8192


def get_config(arch_id: str):
    return REGISTRY[arch_id]


def list_archs():
    return list(REGISTRY)


def needs_sliding_window(cfg: ModelConfig, shape_name: str) -> bool:
    """True when this (arch, shape) runs the sliding-window variant."""
    if shape_name != "long_500k":
        return False
    # SSM state is O(1); hybrid keeps its sparse 1:7 attention full.
    return cfg.family not in ("ssm", "hybrid")


def for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """The config variant that runs a given input shape: at long_500k a
    full-attention LM takes an 8192-token sliding window (its decode
    cache a ring of that size); outside training, no remat."""
    if isinstance(cfg, DiTConfig):
        return cfg
    updates = {}
    if needs_sliding_window(cfg, shape_name):
        updates["sliding_window"] = LONG_CONTEXT_WINDOW
    if INPUT_SHAPES[shape_name]["kind"] != "train":
        updates["remat"] = False
    return dataclasses.replace(cfg, **updates) if updates else cfg


def reduced(cfg):
    """CPU-runnable smoke variant of the same family, as
    ``repro.configs.reduced``: a DiT keeps 2 layers at d_model 64; a
    ``ModelConfig`` 2 layers (a hybrid one group) at d_model 128, head
    width 32, at most 4 experts, a 16-wide SSM state in chunks of 16."""
    if isinstance(cfg, DiTConfig):
        return dataclasses.replace(
            cfg, n_layers=2, n_double=min(cfg.n_double, 1), d_model=64,
            n_heads=4, d_ff=128, text_dim=min(cfg.text_dim, 32),
            n_text_tokens=min(cfg.n_text_tokens, 8), dtype="float32")
    n_layers = 2 if cfg.family != "hybrid" else cfg.attn_every
    d_model, head_dim = 128, 32
    n_heads = d_model // head_dim
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4,
                                  top_k=min(cfg.moe.top_k, 2))
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=max(1, n_heads // 2), d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512, head_dim=head_dim, moe=moe, ssm=ssm,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_prefix_tokens=16 if cfg.n_prefix_tokens else 0,
        sliding_window=0, dtype="float32", remat=False)
