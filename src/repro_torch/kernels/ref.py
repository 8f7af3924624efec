"""Plain PyTorch versions of the port's kernels.

Each is both the CPU path of the op layer and the oracle its CUDA
kernel is held against on the card (with TF32 off).  They repeat the
reference's arithmetic (``repro.kernels.ref``, the full-logits
attention of ``repro.models.attention._sdpa`` and
``repro.models.dit._joint_attention``, and the SSD scan of
``repro.kernels.ssd_scan``), not the kernels'.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import frequency, hermite

_F32 = torch.float32


def token_basis_matmul_ref(basis: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """``y[b, s, d] = Σ_k basis[s, k]·x[b, k, d]`` in float32, cast to
    x.dtype."""
    return torch.einsum("sk,bkd->bsd", basis.to(_F32),
                        x.to(_F32)).to(x.dtype)


def band_split_ref(x: torch.Tensor, rho: float, method: str = "dct"):
    """``(low, high)`` of ``x [B, S, D]`` by ``decompose``'s transform
    path (not the projection matmul the kernel runs)."""
    bands = frequency.transform_bands(x, rho, method, axis=-2)
    return bands.low, bands.high


def freqca_predict_ref(low: torch.Tensor, high_hist: torch.Tensor,
                       ts: torch.Tensor, t_query, order: int) -> torch.Tensor:
    """``low + Hermite(high_hist)(t_query)``: the legacy cached step of
    ``kind="freqca", low_order=0``; output in low.dtype."""
    high = hermite.predict(ts, high_hist, t_query, order)
    return (low.to(_F32) + high.to(_F32)).to(low.dtype)


def band_split_spectral_ref(x: torch.Tensor, rho: float,
                            method: str = "dct"):
    """``(low_spec [B, m, D], high [B, S, D])`` from ``x [B, S, D]``:
    ``low = B·x``, ``high = x − Bᵀ·low``, in float32, cast to x.dtype."""
    basis = frequency.low_band_basis(x.shape[-2], rho, method,
                                     device=x.device)
    xf = x.to(_F32)
    low_spec = torch.einsum("ms,bsd->bmd", basis, xf)
    high = xf - torch.einsum("ms,bmd->bsd", basis, low_spec)
    return low_spec.to(x.dtype), high.to(x.dtype)


def freqca_predict_spectral_ref(low_spec: torch.Tensor, synth: torch.Tensor,
                                high_hist: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """ẑ = synth·low_spec + Σ_k w[b, k]·high_hist[b, k] (per lane)."""
    low = torch.einsum("sm,bmd->bsd", synth.to(_F32), low_spec.to(_F32))
    high = torch.einsum("bk,bksd->bsd", w.to(_F32), high_hist.to(_F32))
    return (low + high).to(high_hist.dtype)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest on
    the 13 low mantissa bits, ties away from zero, which are then
    cleared (the value stays a float32)."""
    bits = v.to(_F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(_F32)


_TF32_STAGE = 32     # the TF32 kernels' reduction depth per stage


def tf32_split_matmul(a: torch.Tensor, b: torch.Tensor,
                      slices: int = 1) -> torch.Tensor:
    """``a @ b`` (``a [M, K]``, ``b [..., K, N]``) as the TF32 kernels
    compute it (``csrc/common.cuh``'s ``Tf32Tile``; for the tests, as
    ``ssd_chunk_scan_parallel_ref`` is): the float32 ``a`` split into
    TF32 ``hi + lo``; a float32 ``b`` split too, 3 products ``a_lo·b_hi
    + a_hi·b_lo + a_hi·b_hi``; a bf16 ``b`` is exact in TF32, 2 products
    ``a_lo·b + a_hi·b``.  A product of two TF32 values is exact in
    float32; each 32-deep stage sums in float32 on its own and the
    stages join in order by float32 adds.  ``slices`` splits K as
    ``band_split_spectral``'s first pass splits S: ``ceil(stages /
    slices)`` stages a slice, each slice summed so, then the slices
    added in order."""
    a = a.to(_F32)
    a_hi = tf32_round(a)
    a_lo = tf32_round(a - a_hi)
    bf = b.to(_F32)
    if b.dtype == torch.bfloat16:
        pairs = [(a_lo, bf), (a_hi, bf)]
    else:
        b_hi = tf32_round(bf)
        pairs = [(a_lo, b_hi), (a_hi, tf32_round(bf - b_hi)), (a_hi, b_hi)]
    k = a.shape[-1]
    stages = -(-k // _TF32_STAGE)
    step = -(-stages // slices) * _TF32_STAGE
    out = None
    for s0 in range(0, k, step):
        acc = None
        for k0 in range(s0, min(k, s0 + step), _TF32_STAGE):
            ks = slice(k0, min(k, k0 + _TF32_STAGE))
            part = None
            for x, y in pairs:
                p = x[:, ks] @ y[..., ks, :]
                part = p if part is None else part + p
            acc = part if acc is None else acc + part
        out = acc if out is None else out + acc
    return out


def band_split_spectral_tf32_ref(x: torch.Tensor, rho: float,
                                 method: str = "dct", slices: int = 1):
    """``band_split_spectral`` as its CUDA kernel computes it (for the
    tests): ``low32 = B·x`` by ``tf32_split_matmul`` with S split in
    ``slices``, then ``high = x − Bᵀ·low32`` (3 products, low32 being
    float32); both cast to x.dtype."""
    basis = frequency.low_band_basis(x.shape[-2], rho, method,
                                     device=x.device)
    low32 = tf32_split_matmul(basis, x, slices)
    high = x.to(_F32) - tf32_split_matmul(basis.T, low32)
    return low32.to(x.dtype), high.to(x.dtype)


def freqca_predict_spectral_tf32_ref(low_spec: torch.Tensor,
                                     synth: torch.Tensor,
                                     high_hist: torch.Tensor,
                                     w: torch.Tensor) -> torch.Tensor:
    """``freqca_predict_fused_spectral`` as its CUDA kernel computes it
    (for the tests): ``synth·low_spec`` by ``tf32_split_matmul``, then
    the K weighted history entries added in slot order."""
    out = tf32_split_matmul(synth, low_spec)
    w = w.to(_F32)
    for k in range(high_hist.shape[1]):
        out = out + w[:, k, None, None] * high_hist[:, k].to(_F32)
    return out.to(high_hist.dtype)


NEG_INF = -1e30      # masked logits, as the reference's attention
NEG_CLIP = -60.0     # the SSD kernel's exp underflow guard


def _acc(x: torch.Tensor) -> torch.dtype:
    """The attention refs' working type: float32, or float64 for float64
    inputs (the oracle of a float32 kernel)."""
    return torch.float64 if x.dtype == torch.float64 else _F32


def _logits(q: torch.Tensor, k: torch.Tensor, mask,
            q_per_kv: int) -> torch.Tensor:
    """Logits ``[B, Hkv, q_per_kv, S, T]`` of ``q [B, S, Hq, hd]``
    against ``k [B, T, Hkv, hd]`` in ``_acc(q)``, scaled by 1/sqrt(hd),
    masked logits −1e30."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, q_per_kv, hd)
    acc = _acc(q)
    logits = torch.einsum("bsgqk,btgk->bgqst", qg.to(acc),
                          k.to(acc)) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    return logits


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask=None, q_per_kv: int = 1) -> torch.Tensor:
    """Full-logits GQA attention (the reference's ``_sdpa``), ``q [B, S,
    Hq, hd]``, ``k, v [B, T, Hkv, hd] -> [B, S, Hq, hd]``; query head
    ``h`` reads kv head ``h // q_per_kv``; ``mask [B?, S, T]`` bool or
    None.  Float32 logits; a masked logit is −1e30, not −inf, so a row
    with no key left is a uniform average, not NaN; probabilities rounded
    to ``v.dtype`` before the PV product, as the bf16 CUDA kernel rounds
    its (unnormalised) probabilities, so at bf16 the two differ by the
    order of their sums and the output's rounding."""
    b, s, hq, hd = q.shape
    probs = torch.softmax(_logits(q, k, mask, q_per_kv), dim=-1).to(v.dtype)
    out = torch.einsum("bgqst,btgk->bsgqk", probs, v)
    return out.reshape(b, s, hq, hd)


def attention_mask(s: int, t: int, causal: bool, window: int,
                   device=None):
    """``[1, S, T]`` bool mask of the flash kernel's forms, or None
    unmasked: causal keeps ``k_pos <= q_pos``, a window ``k_pos > q_pos
    − window``, both positions counted from 0."""
    if not (causal or window > 0):
        return None
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask[None]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_per_kv: int = 1, causal: bool = False,
                  window: int = 0) -> torch.Tensor:
    """The flash kernel's plain version: ``sdpa_ref`` under the masks the
    kernel takes (``attention_mask``).  Unmasked it is the full-logits
    branch of the DiT's joint attention."""
    mask = attention_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return sdpa_ref(q, k, v, mask, q_per_kv)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_per_kv: int = 1, causal: bool = False,
                      window: int = 0):
    """``attention_ref``'s output and the row log-sum-exp of its scaled,
    masked logits, ``lse [B, Hq, S]`` float32 (what the flash forward
    writes for its backward)."""
    b, s, hq, _ = q.shape
    mask = attention_mask(s, k.shape[1], causal, window, q.device)
    lse = torch.logsumexp(_logits(q, k, mask, q_per_kv), dim=-1)
    return sdpa_ref(q, k, v, mask, q_per_kv), lse.reshape(b, hq, s)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      q_per_kv: int = 1, causal: bool = False,
                      window: int = 0):
    """``(dq, dk, dv)`` of ``attention_ref`` by the standard recompute
    from the forward's output ``o`` and row log-sum-exp ``lse [B, Hq,
    S]``, each in its input's type, step by step in float32 (float64
    for float64 inputs, ``_acc``):
    ``P = exp(q·kᵀ/√hd − lse)`` (a masked logit −1e30, so its P is 0),
    ``dV = Pᵀ·dO``, ``D = rowsum(dO ∘ O)``, ``dS = P ∘ (dO·Vᵀ − D)``,
    ``dQ = dS·K/√hd``, ``dK = dSᵀ·Q/√hd``; under GQA a kv head's dK and
    dV sum over its ``q_per_kv`` query heads.  P is rounded to
    ``v.dtype`` before ``Pᵀ·dO`` and dS before both of its products,
    where the bf16 CUDA kernel rounds them (its tensor-core operands);
    the scale is applied after the products.  So at bf16 the two differ
    by the order of their float32 sums and the outputs' rounding.  A row
    that sees no key at all (only a non-causal window past T can make
    one) is outside the recompute: its forward averages, its P here is
    1 per key."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    mask = attention_mask(s, k.shape[1], causal, window, q.device)
    acc = _acc(q)
    p = torch.exp(_logits(q, k, mask, q_per_kv)
                  - lse.to(acc).reshape(b, hkv, q_per_kv, s, 1))
    dog = do.reshape(b, s, hkv, q_per_kv, hd).to(acc)
    og = o.reshape(b, s, hkv, q_per_kv, hd).to(acc)
    dv = torch.einsum("bgqst,bsgqk->btgk", p.to(v.dtype).to(acc), dog)
    d_row = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]   # [b,g,q,s,1]
    dp = torch.einsum("bsgqk,btgk->bgqst", dog, v.to(acc))
    ds = (p * (dp - d_row)).to(v.dtype).to(acc)
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bgqst,btgk->bsgqk", ds, k.to(acc)) * scale
    dk = torch.einsum("bgqst,bsgqk->btgk", ds,
                      q.reshape(b, s, hkv, q_per_kv, hd).to(acc)) * scale
    return (dq.reshape(b, s, hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _tril_exp(diff: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``exp(max(diff, −60))`` where ``keep``, else 0.  The dropped
    entries are selected away before the exp as well as after it: the
    upper triangle's exp overflows at real chunk lengths (cum falls by
    ~177 over 256 tokens at mamba2's init), and autograd through a
    ``where`` over an infinite branch gives 0·inf = NaN.  The values are
    those of one ``where`` after the exp."""
    return torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)
                                       .clamp(min=NEG_CLIP)), 0.0)


def ssd_chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       chunk: int = 256, return_state: bool = False):
    """Mamba2 SSD chunk scan with the TPU kernel's own arithmetic
    (``repro.kernels.ssd_scan._ssd_kernel``), ``x [b, s, h, p]``, ``dt
    [b, s, h]``, ``A [h]``, ``B, C [b, s, n] -> y [b, s, h, p]`` in x's
    type; no D-skip.  ``return_state`` also returns the final state
    ``[b, h, p, n]`` in float32, as the reference's ``ssd_chunked``
    does.  Per chunk, in float32 with the ``[n, p]`` state of
    each (b, h) carried across chunks:
    ``y = ((C Bᵀ) ∘ L)(dt ∘ x) + exp(cum) ∘ (C · state)`` with
    ``L_ij = exp(cum_i − cum_j)`` for ``j <= i``, then the state decays
    by ``exp(cum_last)`` and gains ``Σ_j exp(cum_last − cum_j) dt_j
    B_jᵀ x_j``.  Every ``exp`` clips its argument at −60; the upper
    triangle is selected away (``where``), never multiplied by a 0/1
    mask, since ``exp`` of it can overflow (``_tril_exp``)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunk_scan: S={s} is not a multiple of the "
                         f"chunk {q}")
    a = A.to(_F32)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        xc = x[:, c0:c0 + q].to(_F32)                 # [b, q, h, p]
        dtc = dt[:, c0:c0 + q].to(_F32)               # [b, q, h]
        bc = B[:, c0:c0 + q].to(_F32)                 # [b, q, n]
        cc = C[:, c0:c0 + q].to(_F32)
        cum = torch.cumsum(dtc * a, dim=1)            # [b, q, h]
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # [b, i, j, h]
        lmat = _tril_exp(diff, tri[None, :, :, None])
        scores = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * lmat
        y = torch.einsum("bijh,bjhp->bihp", scores * dtc[:, None], xc)
        decay_in = torch.exp(cum.clamp(min=NEG_CLIP))[..., None]
        y = y + decay_in * torch.einsum("bin,bhnp->bihp", cc, state)
        decay_out = torch.exp((cum[:, -1:] - cum).clamp(min=NEG_CLIP))
        wb = torch.einsum("bjn,bjh->bjhn", bc, dtc * decay_out)
        last = torch.exp(cum[:, -1].clamp(min=NEG_CLIP))[..., None, None]
        state = last * state + torch.einsum("bjhn,bjhp->bhnp", wb, xc)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    return (y, state.transpose(-1, -2)) if return_state else y


def ssd_chunk_scan_parallel_ref(x: torch.Tensor, dt: torch.Tensor,
                                A: torch.Tensor, B: torch.Tensor,
                                C: torch.Tensor,
                                chunk: int = 256) -> torch.Tensor:
    """The CUDA kernel's chunk-parallel algorithm in plain float32 (for
    the tests; the op layer's CPU route is ``ssd_chunk_scan_ref``).  The
    same function as ``ssd_chunk_scan_ref``, computed in its four passes:
    ``G = C Bᵀ`` once per (lane, chunk), shared by the heads; each
    chunk's own contribution ``Σ_j exp(cum_Q − cum_j) dt_j B_jᵀ x_j``;
    the states passed over the chunks, ``state_c = exp(cum_Q)·state_{c−1}
    + contrib_c`` (the recurrence, never one cumulative exp across
    chunks); then ``y = exp(cum) ∘ (C · state_{c−1}) + ((G ∘ L) ∘ dt)
    x``.  Every exp clips at −60 within its chunk."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunk_scan: S={s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q
    xc = x.to(_F32).reshape(b, nc, q, h, p)
    dtc = dt.to(_F32).reshape(b, nc, q, h)
    bc = B.to(_F32).reshape(b, nc, q, n)
    cc = C.to(_F32).reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * A.to(_F32), dim=2)              # [b, c, q, h]
    gram = torch.einsum("bcin,bcjn->bcij", cc, bc)           # pass 1
    w = dtc * torch.exp((cum[:, :, -1:] - cum).clamp(min=NEG_CLIP))
    contrib = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, w, xc)  # pass 2
    decay = torch.exp(cum[:, :, -1].clamp(min=NEG_CLIP))     # [b, c, h]
    state = torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
    entering = []
    for c in range(nc):                                       # pass 3
        entering.append(state)
        state = decay[:, c, :, None, None] * state + contrib[:, c]
    state_in = torch.stack(entering, dim=1)                  # [b, c, h, n, p]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b, c, i, j, h]
    lmat = _tril_exp(diff, tri[..., None])
    m = gram[..., None] * lmat * dtc[:, :, None]             # pass 4
    y = torch.exp(cum.clamp(min=NEG_CLIP))[..., None] * torch.einsum(
        "bcin,bchnp->bcihp", cc, state_in)
    y = y + torch.einsum("bcijh,bcjhp->bcihp", m, xc)
    return y.reshape(b, s, h, p).to(x.dtype)


def ssd_chunk_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor,
                           C: torch.Tensor, dy: torch.Tensor,
                           chunk: int = 256):
    """``(dx, ddt, dA, dB, dC)`` of ``ssd_chunk_scan_ref`` (y only, the
    −60 clip included) for the output gradient ``dy [b, s, h, p]``: the
    plain version of the SSD-scan backward kernel and its oracle.  dx,
    dB and dC in their inputs' types, ddt ``[b, s, h]`` and dA ``[h]``
    float32.  Written out, in float32, per chunk (head h, a = A_h; E(u)
    = exp(max(u, −60)), whose derivative is E(u) where u ≥ −60 and 0
    below, as autograd of ``clamp(min=−60)`` gives it):

    - the forward's states, S_c entering chunk c, and their gradients
      D_c (of the state leaving chunk c) by the reverse recurrence
      ``D_{c−1} = E(cum_Q,c)·D_c + Σ_i E(cum_i) C_iᵀ dy_i``, D_last = 0;
    - M_ij = (C_i·B_j) L_ij and Z_ij = (dy_i·x_j) L_ij dt_j for j ≤ i
      (L_ij = E(cum_i − cum_j)); w_j = dt_j E(cum_Q − cum_j);
    - ``dx_j = dt_j Σ_i M_ij dy_i + w_j (B_j D)``;
      ``dC_i = Σ_j Z_ij B_j + E(cum_i) S dy_i``;
      ``dB_j = Σ_i Z_ij C_i + w_j D x_j``, each summed over heads;
    - ddt_j directly: ``Σ_i M_ij (dy_i·x_j) + E(cum_Q − cum_j) z_j``
      with z_j = x_j·(B_j D);
    - the gradient of cum: P_ij = M_ij (dy_i·x_j) dt_j (j < i, unclipped
      entries) into cum_i and out of cum_j; ``E(cum_i) dy_i·(C_i S)``
      into cum_i; T_j = E(cum_Q − cum_j) dt_j z_j (j < Q−1, unclipped)
      into cum_Q and out of cum_j; ``E(cum_Q) ⟨D, S⟩`` into cum_Q.  The
      diagonal of P and the last T add and take the same amount, so both
      are left out, as in the kernel;
    - cum = cumsum(dt·a) folded back: R = the reverse cumsum of dcum,
      ``ddt += a R``, ``dA = Σ dt R`` over batch and tokens."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunk_scan: S={s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q
    xc = x.to(_F32).reshape(b, nc, q, h, p)
    dyc = dy.to(_F32).reshape(b, nc, q, h, p)
    dtc = dt.to(_F32).reshape(b, nc, q, h)
    bc = B.to(_F32).reshape(b, nc, q, n)
    cc = C.to(_F32).reshape(b, nc, q, n)
    a = A.to(_F32)
    cum = torch.cumsum(dtc * a, dim=2)                       # [b, c, q, h]
    cum_q = cum[:, :, -1]                                    # [b, c, h]
    u_out = cum[:, :, -1:] - cum
    e_out = torch.exp(u_out.clamp(min=NEG_CLIP))             # E(cum_Q − cum_j)
    w = dtc * e_out
    e_in = torch.exp(cum.clamp(min=NEG_CLIP))                # E(cum_i)
    decay = torch.exp(cum_q.clamp(min=NEG_CLIP))             # E(cum_Q)
    contrib = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, w, xc)
    own = torch.einsum("bcin,bcih,bcihp->bchnp", cc, e_in, dyc)
    state = torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = decay[:, c, :, None, None] * state + contrib[:, c]
    s_in = torch.stack(s_in, dim=1)                          # [b, c, h, n, p]
    run = torch.zeros_like(state)
    d_out = [None] * nc
    for c in reversed(range(nc)):
        d_out[c] = run
        run = decay[:, c, :, None, None] * run + own[:, c]
    d_out = torch.stack(d_out, dim=1)                        # [b, c, h, n, p]

    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    strict = tri.tril(-1)[..., None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b, c, i, j, h]
    lmat = _tril_exp(diff, tri[..., None])
    gram = torch.einsum("bcin,bcjn->bcij", cc, bc)
    dg = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    m = gram[..., None] * lmat
    z = dg * lmat * dtc[:, :, None]
    k = m * dg
    pmat = torch.where(strict & (diff >= NEG_CLIP), k * dtc[:, :, None], 0.0)
    v = torch.einsum("bcjn,bchnp->bcjhp", bc, d_out)         # B_j D
    dx = (dtc[..., None] * torch.einsum("bcijh,bcihp->bcjhp", m, dyc)
          + w[..., None] * v)
    dc = (torch.einsum("bcijh,bcjn->bcin", z, bc)
          + torch.einsum("bcih,bcihp,bchnp->bcin", e_in, dyc, s_in))
    db = (torch.einsum("bcijh,bcin->bcjn", z, cc)
          + torch.einsum("bcjh,bcjhp,bchnp->bcjn", w, xc, d_out))
    zj = (xc * v).sum(-1)                                    # [b, c, j, h]
    ddt = k.sum(2) + e_out * zj
    not_last = torch.arange(q, device=x.device) < q - 1
    t = torch.where(not_last[:, None] & (u_out >= NEG_CLIP),
                    e_out * dtc * zj, 0.0)
    y_state = torch.einsum("bcin,bchnp->bcihp", cc, s_in)
    dcum = (pmat.sum(3) - pmat.sum(2) - t
            + torch.where(cum >= NEG_CLIP, e_in * (dyc * y_state).sum(-1),
                          0.0))
    frob = (d_out * s_in).sum((-1, -2))                      # ⟨D, S⟩
    dcum[:, :, -1] += (torch.where(cum_q >= NEG_CLIP, decay * frob, 0.0)
                       + t.sum(2))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = ddt + a * rev
    da = (dtc * rev).sum((0, 1, 2))
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h), da,
            db.reshape(b, s, n).to(B.dtype), dc.reshape(b, s, n).to(C.dtype))


def _bf16_planes(t: torch.Tensor):
    """``(hi, lo)`` of an operand as the SSD kernels stage it: a bf16
    tensor is exact in one plane (lo None); any other is split, hi =
    rn(v) and lo = rn(v − hi) in bf16 (both held as ``ref._F32``)."""
    if t.dtype == torch.bfloat16:
        return t.to(_F32), None
    v = t.to(_F32)
    hi = v.to(torch.bfloat16).to(_F32)
    return hi, (v - hi).to(torch.bfloat16).to(_F32)


def bf16_split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched, broadcasting) as the SSD kernels' bf16
    ``mma.sync`` products compute it (``csrc/ssd_common.cuh``; for the
    tests): a bf16 operand enters exactly, any other is split into bf16
    hi + lo (``_bf16_planes``); hi·hi, plus hi·lo where ``b`` is split,
    plus lo·hi where ``a`` is; lo·lo is dropped.  A product of two bf16
    values is exact in float32; the sums are float32 (``ref._F32``)."""
    a_hi, a_lo = _bf16_planes(a)
    b_hi, b_lo = _bf16_planes(b)
    out = a_hi @ b_hi
    if a_lo is not None:
        out = out + a_lo @ b_hi
    if b_lo is not None:
        out = out + a_hi @ b_lo
    return out


def ssd_chunk_scan_bwd_split_ref(x: torch.Tensor, dt: torch.Tensor,
                                 A: torch.Tensor, B: torch.Tensor,
                                 C: torch.Tensor, dy: torch.Tensor,
                                 chunk: int = 256):
    """``ssd_chunk_scan_bwd_ref``'s gradients as the SSD-scan backward
    kernel decomposes them (for the tests), every product by
    ``bf16_split_matmul`` on the operands the kernel stages: the
    forward's C Bᵀ and states (its passes 1-3: ``gram`` on x's type,
    the states from ``(w ∘ B)ᵀ x``), the state's gradient from ``(E(cum)
    ∘ C)ᵀ dy``; per head ``dy·xᵀ``, ``(dt ∘ M)ᵀ dy`` and ``B D``; Z
    summed over the heads first, then ``(Σ_h Z) B`` and ``(Σ_h Z)ᵀ C``
    once per chunk; the state terms ``dy Sᵀ`` (with ``E(cum_i) Σ_n C_in
    (dy Sᵀ)_in``, the rows' state share of the gradient of cum) and ``x
    Dᵀ`` per head, weighted by E(cum) and w and summed over heads.  The
    elementwise arithmetic and the fold of the gradient of cum are
    ``ssd_chunk_scan_bwd_ref``'s."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunk_scan: S={s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q
    # operands in their own types: a bf16 one is exact, a float32 one split
    xh = x.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)    # [b, c, h, q, p]
    dyh = dy.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)
    bc = B.reshape(b, nc, q, n)
    cc = C.reshape(b, nc, q, n)
    xf = xh.to(_F32)
    dtc = dt.to(_F32).reshape(b, nc, q, h).permute(0, 1, 3, 2)  # [b, c, h, q]
    a = A.to(_F32)
    cum = torch.cumsum(dtc * a[:, None], dim=-1)             # [b, c, h, q]
    cum_q = cum[..., -1]                                     # [b, c, h]
    u_out = cum[..., -1:] - cum
    e_out = torch.exp(u_out.clamp(min=NEG_CLIP))
    w = dtc * e_out
    e_in = torch.exp(cum.clamp(min=NEG_CLIP))
    decay = torch.exp(cum_q.clamp(min=NEG_CLIP))
    gram = bf16_split_matmul(cc, bc.transpose(-1, -2))       # [b, c, i, j]
    wb = w[..., None] * bc.to(_F32)[:, :, None]              # [b, c, h, q, n]
    contrib = bf16_split_matmul(wb.transpose(-1, -2), xh)    # [b, c, h, n, p]
    ec = e_in[..., None] * cc.to(_F32)[:, :, None]
    own = bf16_split_matmul(ec.transpose(-1, -2), dyh)
    state = torch.zeros((b, h, n, p), dtype=_F32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = decay[:, c, :, None, None] * state + contrib[:, c]
    s_in = torch.stack(s_in, dim=1)                          # [b, c, h, n, p]
    run = torch.zeros_like(state)
    d_out = [None] * nc
    for c in reversed(range(nc)):
        d_out[c] = run
        run = decay[:, c, :, None, None] * run + own[:, c]
    d_out = torch.stack(d_out, dim=1)

    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    strict = tri.tril(-1)
    diff = cum[..., :, None] - cum[..., None, :]             # [b, c, h, i, j]
    lmat = _tril_exp(diff, tri)
    dg = bf16_split_matmul(dyh, xh.transpose(-1, -2))        # dy_i·x_j
    m = gram[:, :, None] * lmat
    dtj = dtc[..., None, :]                                  # dt_j
    z = torch.where(tri, dg * lmat * dtj, 0.0)
    k = torch.where(tri, m * dg, 0.0)
    pmat = torch.where(strict & (diff >= NEG_CLIP), k * dtj, 0.0)
    zsum = z.sum(2)                                          # Σ_h Z [b, c, i, j]
    v = bf16_split_matmul(bc[:, :, None], d_out)             # B_j D [b, c, h, q, p]
    mt = (m * dtj).transpose(-1, -2)                         # dt_j M_ij, [j][i]
    dx = bf16_split_matmul(mt, dyh) + w[..., None] * v
    y_s = bf16_split_matmul(dyh, s_in.transpose(-1, -2))     # dy Sᵀ [b, c, h, q, n]
    dc = (bf16_split_matmul(zsum, bc)
          + (e_in[..., None] * y_s).sum(2))
    db = (bf16_split_matmul(zsum.transpose(-1, -2), cc)
          + (w[..., None] * bf16_split_matmul(
              xh, d_out.transpose(-1, -2))).sum(2))
    zj = (xf * v).sum(-1)                                    # [b, c, h, q]
    ddt = k.sum(-2) + e_out * zj
    not_last = torch.arange(q, device=x.device) < q - 1
    t = torch.where(not_last & (u_out >= NEG_CLIP), e_out * dtc * zj, 0.0)
    rst = torch.where(cum >= NEG_CLIP,
                      e_in * (cc.to(_F32)[:, :, None] * y_s).sum(-1), 0.0)
    dcum = pmat.sum(-1) - pmat.sum(-2) - t + rst
    frob = (d_out * s_in).sum((-1, -2))                      # ⟨D, S⟩
    dcum[..., -1] += (torch.where(cum_q >= NEG_CLIP, decay * frob, 0.0)
                      + t.sum(-1))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + a[:, None] * rev
    da = (dtc * rev).sum((0, 1, 3))
    return (dx.permute(0, 1, 3, 2, 4).reshape(b, s, h, p).to(x.dtype),
            ddt.permute(0, 1, 3, 2).reshape(b, s, h), da,
            db.reshape(b, s, n).to(B.dtype), dc.reshape(b, s, n).to(C.dtype))


def ssd_naive_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor):
    """The per-token SSD recurrence, the ground-truth semantics
    (``repro.kernels.ref.ssd_naive_ref``): ``state ← exp(dt·A)·state +
    dt·x ⊗ B``, ``y = state · C``.  Returns ``(y [b, s, h, p]`` in x's
    type, ``final state [b, h, p, n]`` float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    a = A.to(_F32)
    state = torch.zeros((b, h, p, n), dtype=_F32, device=x.device)
    ys = []
    for i in range(s):
        x_t, dt_t = x[:, i].to(_F32), dt[:, i].to(_F32)
        b_t, c_t = B[:, i].to(_F32), C[:, i].to(_F32)
        decay = torch.exp(dt_t * a)                             # [b, h]
        dbx = torch.einsum("bh,bn,bhp->bhpn", dt_t, b_t, x_t)
        state = state * decay[:, :, None, None] + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_t))
    return torch.stack(ys, dim=1).to(x.dtype), state
