"""Plain PyTorch versions of the port's kernels.

Each is both the CPU path of the op layer and the oracle its CUDA
kernel is held against on the card (with TF32 off).  They repeat the
reference's arithmetic (``repro.kernels.ref`` and the full-logits
branch of ``repro.models.dit._joint_attention``), not the kernels'.
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


def attention_ref(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Non-causal MHA, ``q, k, v: [B, S, H, hd] -> [B, S, H, hd]``.

    The full-logits branch of the reference's joint attention: float32
    logits and softmax, probabilities rounded to ``v.dtype`` before the
    PV product (the CUDA kernel keeps them in float32 — the source of
    their bf16 difference)."""
    hd = q.shape[-1]
    logits = torch.einsum("bshk,bthk->bhst", q.to(_F32),
                          k.to(_F32)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)
