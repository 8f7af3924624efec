"""Causal language model: embed -> block stack -> norm -> head
(counterpart of ``repro.models.transformer``).

``forward`` returns the Cumulative Residual Feature (CRF) next to the
logits: the final pre-norm hidden state.  On a CUDA tensor every
attention layer at 2048 tokens or more runs the causal GQA flash kernel
and every mamba2 layer the SSD chunk-scan kernel, each with its
backward kernel under autograd.  ``loss_fn`` is the next-token
cross-entropy of training, through ``chunked_cross_entropy`` so that
the ``[B, S, vocab]`` logits never exist at once.  ``decode_step``
runs one token through the stack against a decode cache
(``blocks.stack_cache_zeros``), updated in place; it launches no kernel.
Configs with experts run the MoE FFN (``models.moe``); enc-dec and the
modality prefix raise.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

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


def check_ported(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` for the LM configs the port does not
    train, prefill or decode yet: enc-dec and modality-prefix."""
    if cfg.is_encdec or cfg.n_prefix_tokens > 0:
        raise NotImplementedError(
            f"{what} ({cfg.arch_id}): enc-dec and modality-prefix configs "
            "are not ported yet (ROADMAP.md §1 item 5)")


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Next-token cross-entropy of ``batch["tokens"] [B, S]`` against
    ``batch["labels"]`` (−1 masked), the reference's ``loss_fn``: the
    stack (rematerialised under grad where ``cfg.remat``), the final
    norm, then ``chunked_cross_entropy``; with experts, plus
    ``aux_loss_weight`` times the load-balance loss and
    ``router_z_weight`` times the router z-loss.  Returns ``(loss,
    metrics)`` with metrics ``loss`` (the total), ``lb_loss`` and
    ``drop_fraction`` (the last two the stack's aux, zero without
    experts).  Configs with a modality prefix or an encoder raise
    ``NotImplementedError`` (``ROADMAP.md`` §1 item 5)."""
    check_ported(cfg, "loss_fn")
    x = common.embed(params["embed"], batch["tokens"]).to(
        getattr(torch, cfg.dtype))
    h, aux = blocks.stack_full(params["stack"], x, cfg)
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
    check_ported(cfg, "decode_step")
    x = common.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    h, cache, _ = blocks.stack_decode(params["stack"], x, cfg, cache,
                                      window=window)
    logits = _head(params, common.rmsnorm(params["final_norm"], h,
                                          cfg.norm_eps), cfg)
    return logits, cache
