"""Causal language model: embed -> block stack -> norm -> head
(counterpart of ``repro.models.transformer``, full-sequence forward).

``forward`` returns the Cumulative Residual Feature (CRF) next to the
logits: the final pre-norm hidden state.  On a CUDA tensor every
attention layer at 2048 tokens or more runs the causal GQA flash kernel
and every mamba2 layer the SSD chunk-scan kernel.  The loss and decode
wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, common
from repro_torch.models.common import ParamSpec


class LMOutput(NamedTuple):
    logits: torch.Tensor
    crf: torch.Tensor
    aux: blocks.BlockAux


def lm_specs(cfg: ModelConfig):
    if cfg.n_prefix_tokens > 0:
        raise NotImplementedError("modality-prefix tokens are not ported "
                                  "yet")
    s: Dict[str, Any] = {
        "embed": common.embed_specs(cfg.vocab_size, cfg.d_model),
        "stack": blocks.stack_specs(cfg),
        "final_norm": common.rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = {"kernel": ParamSpec((cfg.d_model, cfg.vocab_size),
                                         scale=0.02)}
    return s


def _head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return common.unembed(params["embed"], h)
    return h @ params["head"]["kernel"].to(h.dtype)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            window: int = 0) -> LMOutput:
    """tokens: [B, S]."""
    x = common.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    h, aux = blocks.stack_full(params["stack"], x, cfg, window=window)
    logits = _head(params, common.rmsnorm(params["final_norm"], h,
                                          cfg.norm_eps), cfg)
    return LMOutput(logits=logits, crf=h, aux=aux)


def _embedding_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].T
    return params["head"]["kernel"]
