"""Encoder-decoder transformer, the SeamlessM4T-style speech-to-text
backbone (counterpart of ``repro.models.encdec``).

The audio frontend (mel-spectrogram + conv feature extractor) is a
stub: the encoder takes precomputed frame embeddings ``[B, T, d]``,
projects them and runs non-causal attention blocks.  The decoder is a
causal text decoder whose blocks add cross-attention into the encoder
memory.  ``params["encoder"]`` and ``params["decoder"]`` are per-layer
lists (the reference's stacked leaves, unstacked as ``bridge`` does).
On a CUDA tensor the encoder's self-attention from 2048 frames runs the
non-causal flash kernel, the decoder's the causal one, and
cross-attention from s·t >= 2048² the non-causal one with T != S; each
with the flash backward under autograd.  The decode cache is a list of
one ``KVCache`` per decoder layer, updated in place; the memory's K and
V are projected again in every decode step, as in the reference.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks, common, mlp, transformer
from repro_torch.models.common import ParamSpec


class EncDecOutput(NamedTuple):
    logits: torch.Tensor
    crf: torch.Tensor          # decoder CRF
    memory: torch.Tensor       # encoder output


def _dec_block_specs(cfg: ModelConfig, stack: int):
    return {
        "norm1": common.rmsnorm_specs(cfg.d_model),
        "self_attn": attention.attn_specs(cfg, stack),
        "norm_x": common.rmsnorm_specs(cfg.d_model),
        "cross_attn": attention.cross_attn_specs(cfg, stack),
        "norm2": common.rmsnorm_specs(cfg.d_model),
        "ffn": mlp.mlp_specs(cfg, stack),
    }


def encdec_specs(cfg: ModelConfig):
    """The reference's tree, its stacks as per-layer lists; ``ref_shape``
    gives each stacked leaf the reference's fan-in (the 4-D attention
    leaves draw at 1/sqrt(stack depth))."""
    d = cfg.d_model
    return {
        "enc_proj": common.dense_specs(d, d, "embed", None),
        "encoder": [blocks.block_specs(cfg, "attn", False, cfg.n_enc_layers)
                    for _ in range(cfg.n_enc_layers)],
        "enc_norm": common.rmsnorm_specs(d),
        "embed": common.embed_specs(cfg.vocab_size, d),
        "decoder": [_dec_block_specs(cfg, cfg.n_layers)
                    for _ in range(cfg.n_layers)],
        "final_norm": common.rmsnorm_specs(d),
        "head": {"kernel": ParamSpec((d, cfg.vocab_size), scale=0.02,
                                     axes=("embed", "vocab"))},
    }


def _layers(fn, layers, h, *args, remat: bool):
    """``h = fn(layer, h, *args)`` over the layers, each rematerialised
    in the backward where ``remat`` and grad is on (the reference's
    ``jax.checkpoint`` of its scan body)."""
    use_remat = remat and torch.is_grad_enabled()
    for layer in layers:
        h = (checkpoint(fn, layer, h, *args, use_reentrant=False)
             if use_remat else fn(layer, h, *args))
    return h


def _enc_block(layer, h, cfg: ModelConfig):
    return blocks.block_full(layer, h, cfg, "attn", False, causal=False)[0]


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames [B, T, d] (precomputed frontend embeddings) -> the memory
    [B, T, d]."""
    x = common.dense(params["enc_proj"],
                     frames.to(getattr(torch, cfg.dtype)))
    h = _layers(_enc_block, params["encoder"], x, cfg, remat=cfg.remat)
    return common.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def _dec_block(layer, h, memory, cfg: ModelConfig, cache=None,
               window: int = 0):
    """One decoder block: ``(hidden, cache)``; with a cache, one token's
    self-attention against it (updated in place)."""
    hin = common.rmsnorm(layer["norm1"], h, cfg.norm_eps)
    if cache is None:
        h = h + attention.self_attention(layer["self_attn"], hin, cfg,
                                         window=window)
    else:
        y, cache = attention.decode_self_attention(layer["self_attn"], hin,
                                                   cfg, cache, window=window)
        h = h + y
    hx = common.rmsnorm(layer["norm_x"], h, cfg.norm_eps)
    h = h + attention.cross_attention(layer["cross_attn"], hx, memory, cfg)
    h2 = common.rmsnorm(layer["norm2"], h, cfg.norm_eps)
    return h + mlp.mlp(layer["ffn"], h2), cache


def _dec_full(layer, h, memory, cfg: ModelConfig, window: int):
    return _dec_block(layer, h, memory, cfg, window=window)[0]


def decoder(params, tokens: torch.Tensor, memory: torch.Tensor,
            cfg: ModelConfig, window: int = 0,
            remat: bool = False) -> torch.Tensor:
    """The decoder's hidden states (the CRF) over ``tokens [B, S]``
    against ``memory``, before the final norm."""
    x = common.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    return _layers(_dec_full, params["decoder"], x, memory, cfg, window,
                   remat=remat)


def head_logits(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The final norm and the head: h [B, S, d] -> logits [B, S, V]."""
    return common.rmsnorm(params["final_norm"], h, cfg.norm_eps) @ \
        params["head"]["kernel"].to(h.dtype)


def forward(params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, window: int = 0) -> EncDecOutput:
    """frames [B, T, d], tokens [B, S] -> logits [B, S, V], the decoder
    CRF and the memory."""
    memory = encode(params, frames, cfg)
    h = decoder(params, tokens, memory, cfg, window, remat=cfg.remat)
    return EncDecOutput(logits=head_logits(params, h, cfg), crf=h,
                        memory=memory)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Next-token cross-entropy of the decoder over ``batch["tokens"]``
    against ``batch["labels"]`` (−1 masked) given ``batch["frames"]``,
    through ``transformer.chunked_cross_entropy`` (the ``[B, S, 256206]``
    logits never exist at once); encoder and decoder rematerialised under
    grad where ``cfg.remat``.  Returns ``(loss, {"loss": loss})``."""
    memory = encode(params, batch["frames"], cfg)
    h = decoder(params, batch["tokens"], memory, cfg, remat=cfg.remat)
    hn = common.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    loss = transformer.chunked_cross_entropy(params, hn, batch["labels"], cfg)
    return loss, {"loss": loss}


def decode_cache_zeros(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device=None):
    """One empty ``KVCache`` of ``max_len`` slots per decoder layer."""
    return [attention.KVCache.zeros(batch, max_len, cfg.n_kv_heads,
                                    cfg.head_dim, dtype, device)
            for _ in range(cfg.n_layers)]


def decode_cache_abstract(cfg: ModelConfig, batch: int, max_len: int,
                          dtype):
    """``decode_cache_zeros`` on the ``meta`` device (the dry run's
    cache: shapes and types, nothing allocated)."""
    return decode_cache_zeros(cfg, batch, max_len, dtype, device="meta")


def decode_step(params, tokens: torch.Tensor, memory: torch.Tensor, cache,
                cfg: ModelConfig, window: int = 0):
    """One-token decode, tokens [B, 1] against the memory [B, T, d] ->
    ``(logits [B, 1, V], cache)``; the cache is updated in place."""
    h = common.embed(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    for layer, layer_cache in zip(params["decoder"], cache, strict=True):
        h, _ = _dec_block(layer, h, memory, cfg, cache=layer_cache,
                          window=window)
    return head_logits(params, h, cfg), cache
