"""Top-k mixture-of-experts FFN (counterpart of ``repro.models.moe``).

Two dispatches with the same capacity-bounded routing, both plain
tensor code (the reference computes them with einsums and gathers, no
Pallas kernel): ``moe_ffn``, the GShard form, multiplies by a ``[groups,
tokens, experts, capacity]`` one-hot to dispatch and combine;
``moe_ffn_gather`` writes the same routing as slot indices and gathers.
Tokens are routed in groups of ``min(2048, n)``; each expert takes at
most ``cap = max(ceil(g·k·cf / n_experts), k)`` tokens of a group, in
token order, and drops the rest.  The router runs in float32; padded
experts (``e_total > n_experts``) are never routed.

One departure from the reference's gather form: for a dropped slot it
gathers at index ``top_idx·cap + pos`` with ``pos >= cap``, which runs
past ``e·cap`` for the last experts, and ``take_along_axis``'s default
``fill`` mode then returns NaN, which the zero weight does not cancel
(its output is NaN wherever such a slot exists).  Here a slot that is
not kept reads its expert's slot 0 under a zero weight, so both forms
give the einsum form's output, as the reference's docstring intends.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec

_PAD_LOGIT = -1e30     # a padded expert's router logit


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    # fraction of routed (token, k) slots dropped by capacity limits
    drop_fraction: torch.Tensor


def moe_specs(cfg: ModelConfig, stack: int = 1):
    """The router ``[d, e]`` (std 0.02) and the experts' SwiGLU weights
    ``[e, d, f]`` / ``[e, f, d]``.  ``stack``: the reference's layer-stack
    depth; its fan-in rule reads dim 0 of the stacked 4-D expert leaves,
    so they draw with std 1/sqrt(stack)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.e_total
    return {
        "router": ParamSpec((d, e), ref_shape=(stack, d, e), scale=0.02,
                            axes=("embed", "expert")),
        "wi_gate": ParamSpec((e, d, f), ref_shape=(stack, e, d, f),
                             axes=("expert", "embed", "ffn")),
        "wi_up": ParamSpec((e, d, f), ref_shape=(stack, e, d, f),
                           axes=("expert", "embed", "ffn")),
        "wo": ParamSpec((e, f, d), ref_shape=(stack, e, f, d),
                        axes=("expert", "ffn", "embed")),
    }


def _route(logits: torch.Tensor, top_k: int, n_real: int = 0):
    """logits ``[..., E]`` -> (combine weights, mask, probs), each
    ``[..., E]``: the top-k experts by probability, their weights
    renormalised over the selection (floor 1e-9).  Experts from
    ``n_real`` on are padding, their logits set to −1e30 first."""
    e = logits.shape[-1]
    if n_real and n_real < e:
        pad = torch.arange(e, device=logits.device) >= n_real
        logits = logits.masked_fill(pad, _PAD_LOGIT)
    probs = torch.softmax(logits, dim=-1)
    top_idx = torch.topk(probs, top_k, dim=-1).indices
    mask = torch.zeros_like(probs).scatter_(-1, top_idx, 1.0)
    weights = probs * mask
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, mask, probs


def _capacity(cfg: ModelConfig, n: int, group_size: int):
    """(tokens a group, groups, capacity of an expert in a group)."""
    mcfg = cfg.moe
    g = min(group_size, n)
    if n % g:
        raise ValueError(f"tokens {n} not divisible by group {g}")
    cap = max(int(math.ceil(g * mcfg.top_k * mcfg.capacity_factor
                            / mcfg.n_experts)), mcfg.top_k)
    return g, n // g, cap


def _routing(params, xt: torch.Tensor, cfg: ModelConfig):
    """Router logits (float32) and routing of grouped tokens ``xt [n, g,
    d]``: weights, mask, probs ``[n, g, e]`` and ``pos``, each token's
    rank in its expert's buffer (−1 where not routed)."""
    logits = torch.einsum("ngd,de->nge", xt.to(torch.float32),
                          params["router"].to(torch.float32))
    weights, mask, probs = _route(logits, cfg.moe.top_k, cfg.moe.n_experts)
    pos = torch.cumsum(mask, dim=1) * mask - 1.0
    return logits, weights, mask, probs, pos


def _experts(params, xin: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: ``xin [n, e, cap, d]``."""
    dt = xin.dtype
    h = F.silu(torch.einsum("necd,edf->necf", xin,
                            params["wi_gate"].to(dt)))
    h = h * torch.einsum("necd,edf->necf", xin, params["wi_up"].to(dt))
    return torch.einsum("necf,efd->necd", h, params["wo"].to(dt))


def _aux(cfg: ModelConfig, logits, mask, probs, n_kept) -> MoEAux:
    """Switch-style load balance, the router z-loss (over the unpadded
    logits, as the reference's) and the dropped fraction."""
    mcfg = cfg.moe
    frac_tokens = mask.mean(dim=1)
    frac_probs = probs.mean(dim=1)
    lb = (frac_tokens * frac_probs).sum(-1).mean() * mcfg.n_experts
    zl = torch.logsumexp(logits, dim=-1).square().mean()
    n_slots = float(mask.shape[0] * mask.shape[1] * mcfg.top_k)
    dropped = 1.0 - n_kept / n_slots
    return MoEAux(lb.to(torch.float32), zl.to(torch.float32),
                  dropped.to(torch.float32))


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            group_size: int = 2048):
    """x ``[B, S, d]`` -> (``[B, S, d]``, MoEAux), the GShard einsum
    dispatch.  The dispatch one-hot is written by a scatter of each kept
    (token, expert) pair's rank, never an int64 one-hot; the combine
    weights are rounded to x's type first, and ``drop_fraction`` is
    summed from the dispatch tensor in x's type, as the reference's."""
    b, s, d = x.shape
    g, n, cap = _capacity(cfg, b * s, group_size)
    xt = x.reshape(n, g, d)
    logits, weights, mask, probs, pos = _routing(params, xt, cfg)
    keep = (pos >= 0) & (pos < cap)
    e = mask.shape[-1]
    dispatch = torch.zeros((n, g, e, cap), dtype=x.dtype, device=x.device)
    dispatch.scatter_(-1, pos.to(torch.int64).clamp(0, cap - 1)[..., None],
                      keep.to(x.dtype)[..., None])
    combine = dispatch * weights.to(x.dtype)[..., None]
    xin = torch.einsum("ngec,ngd->necd", dispatch, xt)
    y = torch.einsum("ngec,necd->ngd", combine, _experts(params, xin))
    return y.reshape(b, s, d), _aux(cfg, logits, mask, probs,
                                    dispatch.sum())


def moe_ffn_gather(params, x: torch.Tensor, cfg: ModelConfig,
                   group_size: int = 2048):
    """The same routing as ``moe_ffn`` (same capacity drops), dispatched
    by gathers: each group's slot table ``[e·cap]`` names the token a
    slot holds (one scatter; every token not kept writes a dump entry
    past the table, cut off after; kept slots are distinct, which a
    device-side assert checks), the experts read their slots by gather,
    and each token gathers its top-k experts' outputs, weighted.
    ``drop_fraction`` counts the kept pairs."""
    b, s, d = x.shape
    g, n, cap = _capacity(cfg, b * s, group_size)
    xt = x.reshape(n, g, d)
    logits, weights, mask, probs, pos = _routing(params, xt, cfg)
    kept = (pos >= 0) & (pos < cap)
    pos_i = pos.to(torch.int64)
    e = mask.shape[-1]
    experts = torch.arange(e, device=x.device)
    flat_slot = torch.where(kept, experts * cap + pos_i, e * cap)
    toks = torch.arange(g, device=x.device)[None, :, None].expand(n, g, e)
    tbl = torch.zeros((n, e * cap + 1), dtype=torch.int64, device=x.device)
    valid = torch.zeros((n, e * cap + 1), dtype=torch.bool, device=x.device)
    tbl.scatter_(1, flat_slot.reshape(n, -1), toks.reshape(n, -1))
    valid.scatter_(1, flat_slot.reshape(n, -1), True)
    tbl, valid = tbl[:, :-1], valid[:, :-1]
    n_kept = kept.sum()
    torch._assert_async(valid.sum() == n_kept,
                        "moe_ffn_gather: two kept pairs share a slot")

    xin = torch.gather(xt, 1, tbl[..., None].expand(n, e * cap, d))
    xin = (xin * valid[..., None].to(x.dtype)).reshape(n, e, cap, d)
    xout = _experts(params, xin).reshape(n, e * cap, d)

    top_w, top_idx = torch.topk(weights, cfg.moe.top_k, dim=-1)  # [n, g, k]
    pos_k = torch.gather(pos_i, 2, top_idx)
    kept_k = torch.gather(kept, 2, top_idx)
    flat = top_idx * cap + torch.where(kept_k, pos_k, 0)
    gathered = torch.gather(xout, 1, flat.reshape(n, -1, 1).expand(
        n, flat.shape[1] * flat.shape[2], d)).reshape(n, g, -1, d)
    w = (top_w * kept_k.to(top_w.dtype)).to(x.dtype)
    y = (gathered * w[..., None]).sum(dim=2)
    return y.reshape(b, s, d), _aux(cfg, logits, mask, probs, n_kept)
