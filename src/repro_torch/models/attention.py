"""GQA self-attention with RoPE, an optional sliding window and a KV
cache (counterpart of ``repro.models.attention``).

Shapes use ``[batch, seq, heads, head_dim]``.  The projections are
stored as matrices, ``wq [d, H·hd]``, ``wk, wv [d, Hkv·hd]`` and ``wo
[H·hd, d]`` (the reference's ``[d, H, hd]`` / ``[H, hd, d]`` leaves,
reshaped).  From ``_BLOCKWISE_MIN_SEQ`` tokens on, a CUDA tensor goes to
the flash kernel (causal, windowed and GQA forms) through the op layer
and a CPU tensor to ``blockwise_sdpa``, the plain online-softmax version
that is also the kernel's oracle; below it both take the full-logits
path (the reference's ``_sdpa``, ``ref.sdpa_ref``).

Cross-attention (the enc-dec decoder's) projects the queries from the
decoder states and the keys and values from the encoder memory, with no
RoPE and no mask; from s·t >= ``_BLOCKWISE_MIN_SEQ``² it takes the
same two routes (the non-causal flash kernel with T != S on the card),
below it ``ref.sdpa_ref``.

Decode inserts one token into a ``KVCache`` and attends over it with
``ref.sdpa_ref``.  With a window the cache is a ring of ``max_len``
slots; the logical position keeps increasing, so RoPE stays absolute.
Unlike the reference's, the cache is updated in place (a functional
copy of a 32768-slot cache each step would not fit the card), its
position is a host ``int`` (no step reads the device), and a full cache
without a window raises where the reference's clamped write would
overwrite the last slot.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

NEG_INF = ref.NEG_INF     # masked logits
_F32 = torch.float32
# full-materialisation threshold: from here on, blockwise attention (the
# reference's value; the H100's crossover is not measured yet)
_BLOCKWISE_MIN_SEQ = 2048


def attn_specs(cfg: ModelConfig, stack: int = 1):
    """``stack``: the reference's layer-stack depth, which its fan-in
    rule reads on the stacked 4-D leaves."""
    if cfg.use_bias:
        raise NotImplementedError("attention biases are not ported yet")
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, nq * hd), ref_shape=(stack, d, nq, hd),
                        axes=("embed", ("heads", "head_dim"))),
        "wk": ParamSpec((d, nkv * hd), ref_shape=(stack, d, nkv, hd),
                        axes=("embed", ("kv_heads", "kv_head_dim"))),
        "wv": ParamSpec((d, nkv * hd), ref_shape=(stack, d, nkv, hd),
                        axes=("embed", ("kv_heads", "kv_head_dim"))),
        "wo": ParamSpec((nq * hd, d), ref_shape=(stack, nq, hd, d),
                        axes=(("heads", "head_dim"), "embed")),
    }


@dataclasses.dataclass
class KVCache:
    """One attention layer's decode cache: ``k``, ``v [B, max_len, n_kv,
    hd]`` in the model dtype, and ``index``, the next logical position
    (host ``int``; monotonic, also past ``max_len`` on a ring).  Decode
    writes into the buffers and advances ``index`` in place."""
    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @classmethod
    def zeros(cls, batch: int, max_len: int, n_kv: int, head_dim: int,
              dtype, device=None) -> "KVCache":
        shape = (batch, max_len, n_kv, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim

    def heads(name, n):
        return (x @ params["w" + name].to(x.dtype)).reshape(b, s, n, hd)

    q = common.apply_rope(heads("q", cfg.n_heads), positions, cfg.rope_theta)
    k = common.apply_rope(heads("k", cfg.n_kv_heads), positions,
                          cfg.rope_theta)
    return q, k, heads("v", cfg.n_kv_heads)


def blockwise_sdpa(q, k, v, q_per_kv: int, causal: bool = True,
                   window: int = 0, q_block: int = 0,
                   kv_block: int = 1024):
    """Attention with an online softmax over kv tiles (the reference's
    ``blockwise_sdpa``): memory O(q_block × kv_block), float32 running
    max, normaliser and accumulator, masked logits −1e30, the normaliser
    floored at 1e-30.  ``q_block=0`` is one query tile.  q [B, S, Hq,
    hd]; k, v [B, T, Hkv, hd]."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qb = min(q_block, s) if q_block else s
    kb = min(kv_block, t)
    if s % qb or t % kb:
        raise ValueError(f"blockwise_sdpa: S={s}, T={t} are not multiples "
                         f"of the tiles {qb}, {kb}")
    g = q_per_kv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for q0 in range(0, s, qb):
        q_tile = q[:, q0:q0 + qb].reshape(b, qb, hkv, g, hd).to(_F32)
        q_pos = q0 + torch.arange(qb, device=dev)
        acc = torch.zeros((b, hkv, g, qb, hd), dtype=_F32, device=dev)
        m = torch.full((b, hkv, g, qb), NEG_INF, dtype=_F32, device=dev)
        l = torch.zeros((b, hkv, g, qb), dtype=_F32, device=dev)
        for k0 in range(0, t, kb):
            k_pos = k0 + torch.arange(kb, device=dev)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_tile,
                                  k[:, k0:k0 + kb].to(_F32)) * scale
            mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v[:, k0:k0 + kb].to(_F32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))      # [b, qb, hkv, g, hd]
    return torch.cat(outs, dim=1).reshape(b, s, hq, hd).to(q.dtype)


def causal_mask(s: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """[1, S, S+offset] causal (optionally sliding-window) mask."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(s + offset, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None]


def self_attention(params, x: torch.Tensor, cfg: ModelConfig,
                   positions=None, window: int = 0,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence (prefill / denoiser) self-attention, x [B, S, d]."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, x, cfg, positions)
    win = window or cfg.sliding_window
    if s >= _BLOCKWISE_MIN_SEQ:
        if ops._on_cuda(q):
            out = ops.flash(q, k, v, cfg.q_per_kv, causal=causal, window=win)
        else:
            out = blockwise_sdpa(q, k, v, cfg.q_per_kv, causal=causal,
                                 window=win)
    else:
        if causal:
            mask = causal_mask(s, window=win, device=x.device)
        else:
            mask = torch.ones((1, s, s), dtype=torch.bool, device=x.device)
        out = ref.sdpa_ref(q, k, v, mask, cfg.q_per_kv)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype)


def decode_mask(pos: int, max_len: int, window: int, batch: int,
                device=None) -> torch.Tensor:
    """``[B, 1, max_len]`` bool: the slots a query at logical position
    ``pos`` attends to.  Without a window, slot i holds position i; on a
    ring (``window > 0``), slot i holds the largest logical position p
    <= pos with p % max_len == i (floor division: slots ahead of pos
    give negative quotients), valid when 0 <= p and p > pos - window."""
    kpos = torch.arange(max_len, device=device)
    if window > 0:
        logical = kpos + torch.div(pos - kpos, max_len,
                                   rounding_mode="floor") * max_len
        valid = (logical >= 0) & (logical <= pos) & (logical > pos - window)
    else:
        valid = kpos <= pos
    return valid[None, None, :].expand(batch, 1, max_len)


def decode_self_attention(params, x: torch.Tensor, cfg: ModelConfig,
                          cache: KVCache, window: int = 0):
    """One-token decode, x [B, 1, d] -> (y [B, 1, d], cache): the new K
    and V are written into ``cache`` in place, at slot ``pos % max_len``
    on a ring (``window > 0``), else at ``pos``, and ``cache.index``
    advances.  Without a window a full cache raises ``ValueError``."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode consumes one token per step, got {s}")
    max_len = cache.k.shape[1]
    pos = cache.index
    if window <= 0 and pos >= max_len:
        raise ValueError(f"KV cache full: position {pos} of {max_len} "
                         "slots and no window")
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    slot = pos % max_len if window > 0 else pos
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    mask = decode_mask(pos, max_len, window, b, x.device)
    out = ref.sdpa_ref(q, cache.k, cache.v, mask, cfg.q_per_kv)
    cache.index = pos + 1
    return out.reshape(b, 1, -1) @ params["wo"].to(x.dtype), cache


def cross_attn_specs(cfg: ModelConfig, stack: int = 1):
    return attn_specs(cfg, stack)


def cross_attention(params, x: torch.Tensor, memory: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, d] decoder states; memory [B, T, d] encoder output ->
    [B, S, d].  The memory's K and V are projected on every call (decode
    too), as in the reference."""
    b, s, _ = x.shape
    t = memory.shape[1]
    hd = cfg.head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
    k, v = ((memory @ params[w].to(x.dtype)).reshape(b, t, cfg.n_kv_heads,
                                                     hd) for w in ("wk", "wv"))
    if s * t >= _BLOCKWISE_MIN_SEQ ** 2:
        if ops._on_cuda(q):
            out = ops.flash(q, k, v, cfg.q_per_kv, causal=False)
        else:
            out = blockwise_sdpa(q, k, v, cfg.q_per_kv, causal=False)
    else:
        out = ref.sdpa_ref(q, k, v, None, cfg.q_per_kv)
    return out.reshape(b, s, -1) @ params["wo"].to(x.dtype)
