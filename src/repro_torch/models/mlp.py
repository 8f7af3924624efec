"""SwiGLU feed-forward block (counterpart of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec


def mlp_specs(cfg: ModelConfig, stack: int = 1):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ref_shape=(stack, d, f),
                             axes=("embed", "ffn")),
        "wi_up": ParamSpec((d, f), ref_shape=(stack, d, f),
                           axes=("embed", "ffn")),
        "wo": ParamSpec((f, d), ref_shape=(stack, f, d),
                        axes=("ffn", "embed")),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["wi_gate"].to(x.dtype))
    up = x @ params["wi_up"].to(x.dtype)
    return (gate * up) @ params["wo"].to(x.dtype)
