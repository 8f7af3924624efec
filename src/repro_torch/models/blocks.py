"""Decoder blocks and layer stacks (counterpart of
``repro.models.blocks``).

A block = pre-norm mixer (attention or Mamba2 SSD) + pre-norm FFN
(dense SwiGLU, or on the layers ``cfg.is_moe_layer`` picks the mixture
of experts of ``models.moe``, dispatched as ``cfg.moe.impl`` says).  The
reference scans one stacked group of layers; the port keeps
``params["stack"]`` as a list of ``n_groups`` groups, each a dict
``{"l{i}": block}`` over the group's positions, and loops over it, each
group rematerialised in the backward where the config asks for it.
The decode cache mirrors it: a list of ``n_groups`` dicts ``{"l{i}":
KVCache or SSMCache}``, updated in place one token at a time.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mlp, moe, ssm


class BlockAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    drop_fraction: torch.Tensor

    @classmethod
    def zero(cls, device=None):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(z, z, z)

    def __add__(self, other):
        return BlockAux(*[a + b for a, b in zip(self, other, strict=True)])


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool, stack: int = 1):
    s: Dict[str, Any] = {"norm1": common.rmsnorm_specs(cfg.d_model)}
    if kind == "attn":
        s["attn"] = attention.attn_specs(cfg, stack)
    else:
        s["ssm"] = ssm.ssm_specs(cfg, stack)
    if is_moe or cfg.d_ff > 0:
        s["norm2"] = common.rmsnorm_specs(cfg.d_model)
        s["ffn"] = (moe.moe_specs(cfg, stack) if is_moe
                    else mlp.mlp_specs(cfg, stack))
    return s


def _mixer_full(params, x, cfg: ModelConfig, kind: str, window: int,
                causal: bool = True):
    if kind == "attn":
        return attention.self_attention(params["attn"], x, cfg, window=window,
                                        causal=causal)
    return ssm.ssm_block(params["ssm"], x, cfg)


def _ffn(params, x, cfg: ModelConfig,
         is_moe: bool) -> Tuple[torch.Tensor, BlockAux]:
    if is_moe:
        fn = moe.moe_ffn_gather if cfg.moe.impl == "gather" else moe.moe_ffn
        y, aux = fn(params["ffn"], x, cfg)
        return y, BlockAux(*aux)
    return mlp.mlp(params["ffn"], x), BlockAux.zero(x.device)


def block_full(params, x, cfg: ModelConfig, kind: str, is_moe: bool,
               window: int = 0, causal: bool = True):
    """Full-sequence block (prefill / denoiser)."""
    h = x + _mixer_full(params, common.rmsnorm(params["norm1"], x,
                                               cfg.norm_eps),
                        cfg, kind, window, causal)
    if "ffn" not in params:
        return h, BlockAux.zero(x.device)
    f, aux = _ffn(params, common.rmsnorm(params["norm2"], h, cfg.norm_eps),
                  cfg, is_moe)
    return h + f, aux


def block_decode(params, x, cfg: ModelConfig, kind: str, is_moe: bool,
                 cache, window: int = 0):
    """One-token decode block: ``(hidden, cache, aux)``; the layer's
    cache is updated in place."""
    hin = common.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        y, cache = attention.decode_self_attention(params["attn"], hin, cfg,
                                                   cache, window=window)
    else:
        y, cache = ssm.ssm_decode_step(params["ssm"], hin, cfg, cache)
    h = x + y
    if "ffn" not in params:
        return h, cache, BlockAux.zero(x.device)
    f, aux = _ffn(params, common.rmsnorm(params["norm2"], h, cfg.norm_eps),
                  cfg, is_moe)
    return h + f, cache, aux


def _layer_plan(cfg: ModelConfig):
    """(group_size, n_groups, [(kind, is_moe)] per position in a group):
    homogeneous stacks are groups of one layer, hybrid stacks groups of
    ``attn_every`` layers."""
    kinds = cfg.layer_kinds()
    moes = tuple(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    if cfg.family == "hybrid" and cfg.attn_every > 0:
        gs = cfg.attn_every
        if cfg.n_layers % gs:
            raise ValueError("n_layers must be a multiple of attn_every")
        plan = tuple(zip(kinds[:gs], moes[:gs], strict=True))
        for g in range(cfg.n_layers // gs):
            if tuple(zip(kinds[g * gs:(g + 1) * gs], moes[g * gs:(g + 1) * gs],
                         strict=True)) != plan:
                raise ValueError("every group must have the same plan")
        return gs, cfg.n_layers // gs, plan
    if any(k != kinds[0] for k in kinds) or any(m != moes[0] for m in moes):
        raise ValueError("a non-hybrid stack must be homogeneous")
    return 1, cfg.n_layers, ((kinds[0], moes[0]),)


def stack_specs(cfg: ModelConfig):
    _, ng, plan = _layer_plan(cfg)
    return [{f"l{i}": block_specs(cfg, kind, is_moe, ng)
             for i, (kind, is_moe) in enumerate(plan)} for _ in range(ng)]


def _group_full(group, h, cfg: ModelConfig, plan, window: int,
                causal: bool):
    """One group of blocks: ``(hidden, the group's summed aux)``."""
    aux = BlockAux.zero(h.device)
    for i, (kind, is_moe) in enumerate(plan):
        h, a = block_full(group[f"l{i}"], h, cfg, kind, is_moe,
                          window=window, causal=causal)
        aux = aux + a
    return h, aux


def stack_full(params, x, cfg: ModelConfig, window: int = 0,
               causal: bool = True, remat: Optional[bool] = None):
    """Run the layer stack over a sequence.  Returns ``(hidden, aux)``;
    ``hidden`` is the Cumulative Residual Feature (CRF): the input plus
    every residual update.  ``aux`` is the mean over layers, as the
    reference's.  ``remat`` (default ``cfg.remat``, the reference's
    rule) recomputes each group in the backward instead of keeping its
    activations: under grad each group runs in
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant), the
    counterpart of the reference's ``jax.checkpoint`` of the scan body.
    With grad off it changes nothing; the values are the same either
    way."""
    _, ng, plan = _layer_plan(cfg)
    use_remat = (cfg.remat if remat is None else remat) \
        and torch.is_grad_enabled()
    h = x
    aux = BlockAux.zero(x.device)
    for group in params:
        if use_remat:
            h, a = checkpoint(_group_full, group, h, cfg, plan, window,
                              causal, use_reentrant=False)
        else:
            h, a = _group_full(group, h, cfg, plan, window, causal)
        aux = aux + a
    return h, BlockAux(*(a / (ng * len(plan)) for a in aux))


def stack_cache_zeros(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device=None):
    """An empty decode cache for the whole stack: one dict ``{"l{i}":
    cache}`` per group, a ``KVCache`` of ``max_len`` slots for an
    attention layer, an ``SSMCache`` for a mamba2 one."""
    _, ng, plan = _layer_plan(cfg)

    def one(kind):
        if kind == "attn":
            return attention.KVCache.zeros(batch, max_len, cfg.n_kv_heads,
                                           cfg.head_dim, dtype, device)
        return ssm.SSMCache.zeros(batch, cfg, dtype, device)
    return [{f"l{i}": one(kind) for i, (kind, _) in enumerate(plan)}
            for _ in range(ng)]


def stack_cache_abstract(cfg: ModelConfig, batch: int, max_len: int, dtype):
    """``stack_cache_zeros`` on the ``meta`` device: the decode cache's
    shapes and types with nothing allocated (the dry run's counterpart
    of the reference's ``ShapeDtypeStruct`` cache)."""
    return stack_cache_zeros(cfg, batch, max_len, dtype, device="meta")


def stack_cache_axes(cfg: ModelConfig):
    """The reference's logical axes of each cache buffer, in the port's
    per-group layout (no ``"layer"`` axis; a KV cache's position is a
    host ``int`` and has none)."""
    _, ng, plan = _layer_plan(cfg)

    def one(kind):
        if kind == "attn":
            kv = ("batch", "len", "kv_heads", "kv_head_dim")
            return attention.KVCache(k=kv, v=kv)
        return ssm.SSMCache(conv=("batch", None, "inner"),
                            state=("batch", "ssm_heads", None, None))
    return [{f"l{i}": one(kind) for i, (kind, _) in enumerate(plan)}
            for _ in range(ng)]


def stack_decode(params, x, cfg: ModelConfig, cache, window: int = 0):
    """One-token decode through the stack, x [B, 1, d].  Returns
    ``(hidden, cache, aux)``; every layer's cache is updated in place and
    ``aux`` is the mean over layers, as the reference's."""
    _, ng, plan = _layer_plan(cfg)
    h = x
    aux = BlockAux.zero(x.device)
    for group, group_cache in zip(params, cache, strict=True):
        for i, (kind, is_moe) in enumerate(plan):
            h, _, a = block_decode(group[f"l{i}"], h, cfg, kind, is_moe,
                                   group_cache[f"l{i}"], window=window)
            aux = aux + a
    return h, cache, BlockAux(*(a / (ng * len(plan)) for a in aux))
