"""Frequency bases of the FreqCa band split (paper §3.2, eq. 1).

Counterpart of ``repro.core.frequency``: the DCT-II basis, the low-pass
bin rule and the real orthonormal low-band basis ``B: [m, S]`` with
``L = Bᵀ B``.  The bases are built once per ``(S, rho, method)`` in
float64 numpy and cast on use.
"""
from __future__ import annotations

import functools
import math
from typing import Literal, Optional

import numpy as np
import torch

Method = Literal["fft", "dct", "none"]


@functools.lru_cache(maxsize=None)
def _dct_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis C with C @ C.T = I; rows = frequencies."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    basis = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return basis


def low_pass_mask_np(n: int, rho: float, method: Method) -> np.ndarray:
    """Boolean mask over the n frequency bins; True = low-frequency.

    Both transforms target ``m = round(n * rho)`` (clamped to [1, n])
    kept bins.  The DCT spectrum is one-sided: low = [0, m).  The
    real-signal FFT projection must be conjugate-symmetric — DC plus
    whole ±frequency pairs, an odd count — so an even target rounds
    *up* to ``m + 1`` kept bins (``k = m // 2`` pairs).
    """
    m = min(max(int(round(n * rho)), 1), n)
    idx = np.arange(n)
    if method == "fft":
        k = m // 2
        return (idx <= k) | (idx >= n - k)
    return idx < m


def kept_bins(n: int, rho: float, method: Method) -> int:
    """Number of low-frequency bins ``low_pass_mask_np`` keeps."""
    return int(low_pass_mask_np(n, rho, method).sum())


def spectral_kept_bins(n: int, rho: float, method: Method) -> int:
    """Rows of ``low_band_basis`` — the spectral low-ring width.

    ``method="none"`` has an empty low band; a single all-zero basis row
    keeps the cache state shapes static.
    """
    if method == "none":
        return 1
    return kept_bins(n, rho, method)


# unbounded, as in the reference: a multi-resolution deployment keeps
# one basis per (n, rho, method) live, and the bases are small
@functools.lru_cache(maxsize=None)
def _low_band_basis_np(n: int, rho: float, method: Method) -> np.ndarray:
    """Real orthonormal basis ``B: [m, n]`` spanning the low band.

    DCT: the first m rows of the orthonormal DCT-II basis.  FFT: the
    real Fourier basis for the conjugate-symmetric kept set — DC, then
    (cos, sin) row pairs per kept ±frequency pair (a lone normalised cos
    row at Nyquist).  ``none``: one all-zero row.
    """
    if method == "none":
        return np.zeros((1, n), np.float64)
    if method == "dct":
        return _dct_basis_np(n)[:kept_bins(n, rho, method)]
    if method != "fft":
        raise ValueError(f"unknown band-split method {method!r}")
    mask = low_pass_mask_np(n, rho, "fft")
    k = int(mask[1:(n // 2) + 1].sum())      # kept positive frequencies
    i = np.arange(n, dtype=np.float64)
    rows = [np.full(n, 1.0 / math.sqrt(n))]
    for f in range(1, k + 1):
        ang = 2.0 * np.pi * f * i / n
        if 2 * f == n:                       # Nyquist: lone real mode
            rows.append(np.cos(ang) / math.sqrt(n))
        else:
            rows.append(np.cos(ang) * math.sqrt(2.0 / n))
            rows.append(np.sin(ang) * math.sqrt(2.0 / n))
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def _low_band_basis_t(n: int, rho: float, method: Method, dtype, device):
    return torch.as_tensor(_low_band_basis_np(n, rho, method),
                           dtype=dtype, device=device)


def low_band_basis(n: int, rho: float, method: Method,
                   dtype=torch.float32,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """``B: [m, n]`` as a tensor on ``device`` (cached per device, so
    the hot path never re-uploads it)."""
    return _low_band_basis_t(n, rho, method, dtype,
                             torch.device(device or "cpu"))
