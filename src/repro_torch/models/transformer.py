"""Causal language model: embed -> block stack -> norm -> head
(counterpart of ``repro.models.transformer``), and its VLM variant:
precomputed vision-frontend patch embeddings (the stub of the modality
frontend) are projected by ``prefix_proj`` and prepended to the token
embeddings; the loss counts the text positions only.

``forward`` returns the Cumulative Residual Feature (CRF) next to the
logits: the final pre-norm hidden state.  On a CUDA tensor every
attention layer at 2048 tokens or more runs the causal GQA flash kernel
and every mamba2 layer the SSD chunk-scan kernel, each with its
backward kernel under autograd.  ``loss_fn`` is the next-token
cross-entropy of training, through ``chunked_cross_entropy`` so that
the ``[B, S, vocab]`` logits never exist at once.  ``decode_step``
runs one token through the stack against a decode cache
(``blocks.stack_cache_zeros``), updated in place; it launches no kernel.
Configs with experts run the MoE FFN (``models.moe``); the enc-dec
backbone is ``models.encdec``.  Decode takes text tokens only, as the
reference's: a prefix config's cache holds no prefix.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, common
from repro_torch.models.common import ParamSpec


class LMOutput(NamedTuple):
    logits: torch.Tensor
    crf: torch.Tensor
    aux: blocks.BlockAux


def lm_specs(cfg: ModelConfig):
    s: Dict[str, Any] = {
        "embed": common.embed_specs(cfg.vocab_size, cfg.d_model),
        "stack": blocks.stack_specs(cfg),
        "final_norm": common.rmsnorm_specs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = {"kernel": ParamSpec((cfg.d_model, cfg.vocab_size),
                                         scale=0.02, axes=("embed", "vocab"))}
    if cfg.n_prefix_tokens > 0:
        # projection of the (stubbed) modality frontend's embeddings
        s["prefix_proj"] = common.dense_specs(cfg.d_model, cfg.d_model,
                                              "embed", None)
    return s


def _head(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return common.unembed(params["embed"], h)
    return h @ params["head"]["kernel"].to(h.dtype)


def embed_inputs(params, tokens: torch.Tensor, cfg: ModelConfig,
                 prefix_embeds: Optional[torch.Tensor] = None):
    """The stack's input: the token embeddings in the model dtype, after
    the projected ``prefix_embeds [B, P, d]`` where given."""
    dtype = getattr(torch, cfg.dtype)
    x = common.embed(params["embed"], tokens).to(dtype)
    if prefix_embeds is None:
        return x
    pe = common.dense(params["prefix_proj"], prefix_embeds.to(dtype))
    return torch.cat([pe, x], dim=1)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: int = 0) -> LMOutput:
    """tokens [B, S_text]; prefix_embeds [B, P, d] or None.  The logits
    and CRF cover the prefix positions too."""
    x = embed_inputs(params, tokens, cfg, prefix_embeds)
    h, aux = blocks.stack_full(params["stack"], x, cfg, window=window)
    logits = _head(params, common.rmsnorm(params["final_norm"], h,
                                          cfg.norm_eps), cfg)
    return LMOutput(logits=logits, crf=h, aux=aux)


def _embedding_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].T
    return params["head"]["kernel"]


def _ce_chunk(hc: torch.Tensor, lc: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Σ of the masked next-token NLL over one chunk ``hc [B, c, d]``,
    ``lc [B, c]`` (−1 masked), in float32."""
    logits = (hc @ w.to(hc.dtype)).to(torch.float32)
    valid = lc >= 0
    gold_ids = torch.clamp(lc, min=0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, gold_ids[..., None])[..., 0]
    return torch.sum((logz - gold) * valid)


def chunked_cross_entropy(params, h: torch.Tensor, labels: torch.Tensor,
                          cfg: ModelConfig, chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked mean cross-entropy so the ``[B, S, vocab]``
    logits never exist at once: h is the final-normed hidden ``[B, S,
    d]``, labels ``[B, S]`` with −1 masked.  The chunk is the largest
    divisor of S at most ``chunk``; the NLL is summed in float32 over the
    valid positions and divided by their count (at least 1).  Under grad
    each chunk's body runs in ``torch.utils.checkpoint`` (non-reentrant),
    so its logits are recomputed in the backward, as the reference's
    ``jax.checkpoint`` of the scan body recomputes them."""
    b, s, _ = h.shape
    c = min(chunk, s)
    while s % c:          # largest divisor of s at most `chunk`
        c -= 1
    w = _embedding_matrix(params, cfg)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, c):
        hc, lc = h[:, c0:c0 + c], labels[:, c0:c0 + c]
        tot = tot + (checkpoint(_ce_chunk, hc, lc, w, use_reentrant=False)
                     if remat else _ce_chunk(hc, lc, w))
    cnt = torch.sum(labels >= 0)
    return tot / torch.clamp(cnt, min=1)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Next-token cross-entropy of ``batch["tokens"] [B, S]`` against
    ``batch["labels"]`` (−1 masked), the reference's ``loss_fn``: the
    stack (rematerialised under grad where ``cfg.remat``), the final
    norm, then ``chunked_cross_entropy``; with experts, plus
    ``aux_loss_weight`` times the load-balance loss and
    ``router_z_weight`` times the router z-loss.  Returns ``(loss,
    metrics)`` with metrics ``loss`` (the total), ``lb_loss`` and
    ``drop_fraction`` (the last two the stack's aux, zero without
    experts).  With a modality prefix, ``batch["prefix_embeds"] [B, P,
    d]`` is projected and prepended, and its positions are dropped before
    the loss (the labels cover the text)."""
    x = embed_inputs(params, batch["tokens"], cfg,
                     batch["prefix_embeds"] if cfg.n_prefix_tokens > 0
                     else None)
    h, aux = blocks.stack_full(params["stack"], x, cfg)
    if cfg.n_prefix_tokens > 0:
        h = h[:, cfg.n_prefix_tokens:]
    hn = common.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    loss = chunked_cross_entropy(params, hn, batch["labels"], cfg)
    if cfg.moe is not None:
        loss = (loss + cfg.moe.aux_loss_weight * aux.load_balance_loss
                + cfg.moe.router_z_weight * aux.router_z_loss)
    metrics = {"loss": loss, "lb_loss": aux.load_balance_loss,
               "drop_fraction": aux.drop_fraction}
    return loss, metrics


def decode_step(params, tokens: torch.Tensor, cache, cfg: ModelConfig,
                window: int = 0):
    """tokens [B, 1] -> ``(logits [B, 1, V], cache)``; the cache is
    updated in place.  ``window > 0`` treats every KV cache as a ring of
    its length."""
    x = common.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    h, cache, _ = blocks.stack_decode(params["stack"], x, cfg, cache,
                                      window=window)
    logits = _head(params, common.rmsnorm(params["final_norm"], h,
                                          cfg.norm_eps), cfg)
    return logits, cache
