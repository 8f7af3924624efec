"""Step builders (counterpart of ``repro.launch.steps``): the LM train
step with AdamW and gradient accumulation, the prefill step and the
decode step.

``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` keep
the reference's arithmetic and return values; they run eagerly on the
tensors' device (on the card the scan and attention kernels and their
backwards; decode launches none).  The AdamW update is in place
(``optim.adamw.update``), so the parameters a train step returns are
the ones it was given; so is the decode cache.  The mesh, the
``constrain`` sharding hooks and ``build`` / ``input_specs`` /
``build_dit`` wait for the sharding and dry-run part of ``ROADMAP.md``
§1 item 6, and so do the reference's MoE overrides ``moe_impl`` /
``moe_pad``.  An enc-dec config takes ``models.encdec``'s specs, loss,
prefill (``batch["frames"]``) and decode step (against an encoder
memory); a modality-prefix config's batches carry
``batch["prefix_embeds"]``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, common, encdec, transformer
from repro_torch.optim import adamw


def model_specs(cfg: ModelConfig):
    """The parameter specs of an LM config: ``encdec.encdec_specs`` for
    an enc-dec one, else ``transformer.lm_specs``."""
    if cfg.is_encdec:
        return encdec.encdec_specs(cfg)
    return transformer.lm_specs(cfg)


def loss_fn(cfg: ModelConfig):
    """The config's ``loss_fn(params, batch, cfg)``."""
    return encdec.loss_fn if cfg.is_encdec else transformer.loss_fn


def param_bytes(cfg: ModelConfig, bytes_per: int = 2) -> int:
    """Total parameter bytes of an LM config from its specs, no
    allocation (the reference's ``repro.sharding.partitioning
    .param_bytes``; the port's per-group leaves hold the same elements
    as the reference's stacked ones)."""
    leaves = []
    common.map_specs(leaves.append, model_specs(cfg))
    return sum(math.prod(s.shape) * bytes_per for s in leaves)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    microbatch: int = 1):
    """``(train_step, opt_cfg)``: ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)`` takes the gradient of the config's
    ``loss_fn`` with respect to every leaf (each is made to
    require grad) and applies one AdamW update in place.  The default
    optimizer keeps bf16 moments above 2e11 parameter bytes, else
    float32, as the reference's.  ``microbatch > 1`` is gradient
    accumulation: the batch splits into ``microbatch`` sub-batches along
    its first axis, run in order, each gradient added in float32 divided
    by the count, and each metric the mean over the sub-batches; an
    unused leaf's gradient is zero (``None`` without accumulation, which
    AdamW counts as zero).  The metrics are the loss's and AdamW's
    (``grad_norm``, ``lr``), as 0-d tensors."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        moment_dtype="bfloat16" if param_bytes(cfg) > 2e11 else "float32")
    loss_of = loss_fn(cfg)

    def grads_of(params, flat, batch):
        loss, metrics = loss_of(params, batch, cfg)
        return metrics, torch.autograd.grad(loss, flat, allow_unused=True)

    def train_step(params, opt_state, batch):
        flat = [p.requires_grad_(True) for p in adamw.leaves(params)]
        if microbatch > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat]
            runs = []
            for k in range(microbatch):
                one = {key: v.reshape((microbatch, v.shape[0] // microbatch)
                                      + tuple(v.shape[1:]))[k]
                       for key, v in batch.items()}
                metrics, grads = grads_of(params, flat, one)
                for a, g in zip(acc, grads, strict=True):
                    if g is not None:
                        a.add_(g.to(torch.float32) / microbatch)
                runs.append({k2: m.detach() for k2, m in metrics.items()})
                del grads
            grads = acc
            metrics = {key: torch.stack([r[key] for r in runs]).mean()
                       for key in runs[0]}
        else:
            metrics, grads = grads_of(params, flat, batch)
            metrics = {key: m.detach() for key, m in metrics.items()}
        it = iter(grads)
        tree = adamw.tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw.update(opt_cfg, tree, opt_state, params)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step, opt_cfg


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> [B, vocab]``: the full-sequence
    forward of ``batch["tokens"]`` without remat and under
    ``torch.no_grad``, then the last token's logits only (the ``[B, S,
    vocab]`` tensor never exists).  An enc-dec config encodes
    ``batch["frames"]`` first and runs the decoder against it; a prefix
    config prepends the projected ``batch["prefix_embeds"]``."""

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encdec:
            memory = encdec.encode(params, batch["frames"], cfg)
            h = encdec.decoder(params, batch["tokens"], memory, cfg)
            return encdec.head_logits(params, h[:, -1:], cfg)[:, 0]
        x = transformer.embed_inputs(
            params, batch["tokens"], cfg,
            batch["prefix_embeds"] if cfg.n_prefix_tokens > 0 else None)
        h, _ = blocks.stack_full(params["stack"], x, cfg, remat=False)
        hn = common.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        w = transformer._embedding_matrix(params, cfg)
        return (hn @ w.to(hn.dtype))[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    """``decode_step(params, tokens [B, 1], cache) -> (logits [B, 1, V],
    cache)`` under ``torch.no_grad``: ``transformer.decode_step``, the
    cache updated in place.  An enc-dec config's step is
    ``decode_step(params, tokens, cache, memory)``, the decoder against
    the encoder memory (``encdec.decode_step``; its cache from
    ``encdec.decode_cache_zeros``)."""
    if cfg.is_encdec:
        @torch.no_grad()
        def encdec_step(params, tokens, cache, memory):
            return encdec.decode_step(params, tokens, memory, cache, cfg,
                                      window=window)
        return encdec_step

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        return transformer.decode_step(params, tokens, cache, cfg,
                                       window=window)

    return decode_step
