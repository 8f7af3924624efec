"""Plain PyTorch versions of the port's kernels.

Each is both the CPU path of the op layer and the oracle its CUDA
kernel is held against on the card (with TF32 off).  They repeat the
reference's arithmetic (``repro.kernels.ref`` and the full-logits
branch of ``repro.models.dit._joint_attention``), not the kernels'.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import frequency

_F32 = torch.float32


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
