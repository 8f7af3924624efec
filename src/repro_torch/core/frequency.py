"""Frequency decomposition of cached features (paper §3.2, eq. 1).

Counterpart of ``repro.core.frequency``: the DCT-II basis and transform,
the low-pass bin rule, the real orthonormal low-band basis ``B: [m, S]``
with ``L = Bᵀ B``, and ``decompose``, which splits a feature into
complementary low and high bands with ``low + high == z``.  The bases
are built once per ``(S, rho, method)`` in float64 numpy and cast on
use.
"""
from __future__ import annotations

import functools
import math
from typing import Literal, NamedTuple, Optional, Tuple

import numpy as np
import torch

Method = Literal["fft", "dct", "none"]
_F32 = torch.float32


class Bands(NamedTuple):
    low: torch.Tensor
    high: torch.Tensor


@functools.lru_cache(maxsize=None)
def _dct_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis C with C @ C.T = I; rows = frequencies."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    basis = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return basis


@functools.lru_cache(maxsize=None)
def _dct_basis_t(n: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(_dct_basis_np(n), dtype=dtype, device=device)


def dct_basis(n: int, dtype=_F32,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """``C: [n, n]`` on ``device`` (cached per device; callers must not
    write to it)."""
    return _dct_basis_t(n, dtype, torch.device(device or "cpu"))


def dct(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Orthonormal DCT-II along ``axis`` (float32 arithmetic)."""
    c = dct_basis(x.shape[axis], device=x.device)
    xm = torch.movedim(x, axis, -1).to(_F32)
    return torch.movedim(xm @ c.T, -1, axis).to(x.dtype)


def idct(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    c = dct_basis(x.shape[axis], device=x.device)
    xm = torch.movedim(x, axis, -1).to(_F32)
    return torch.movedim(xm @ c, -1, axis).to(x.dtype)


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


def low_pass_mask(n: int, rho: float, method: Method,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.as_tensor(low_pass_mask_np(n, rho, method), device=device)


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


def transform_bands(z: torch.Tensor, rho: float, method: Method,
                    axis: int = -2) -> Bands:
    """The reference's transform path of ``decompose``: mask the DCT-II
    or FFT spectrum along ``axis`` in float32, transform back, cast to
    ``z.dtype``; ``high = z − low`` in ``z``'s type.  Plain PyTorch on
    any device and layout, and the oracle of the band-split kernel."""
    if method == "none":
        return Bands(low=torch.zeros_like(z), high=z)
    n = z.shape[axis]
    shape = [1] * z.ndim
    shape[axis] = n
    mask = low_pass_mask(n, rho, method, device=z.device).reshape(shape)
    if method == "fft":
        zf = torch.fft.fft(z.to(_F32), dim=axis)
        low = torch.fft.ifft(torch.where(mask, zf, 0), dim=axis).real
        low = low.to(z.dtype)
        return Bands(low=low, high=z - low)
    if method == "dct":
        zf = dct(z.to(_F32), axis=axis)
        low = idct(torch.where(mask, zf, 0.0), axis=axis).to(z.dtype)
        return Bands(low=low, high=z - low)
    raise ValueError(f"unknown band-split method {method!r}")


def decompose(z: torch.Tensor, rho: float, method: Method,
              axis: int = -2) -> Bands:
    """Split features into complementary low/high bands (paper eq. 1).

    ``z: [..., S, D]`` with the token axis at ``axis``; ``rho`` is the
    fraction of the spectrum kept as low frequency.  Returns
    spatial-domain bands with ``low + high == z``.  A CUDA tensor in the
    ``[B, S, D]`` token layout goes to the band-split kernel
    (``ops.band_split``) whatever S and D are; every other call takes the
    plain transform path (``transform_bands``).
    """
    if method == "none":
        return Bands(low=torch.zeros_like(z), high=z)
    if z.ndim == 3 and axis in (1, -2):
        from repro_torch.kernels import ops   # lazy: ops imports us
        if ops._on_cuda(z):
            low, high = ops.band_split(z, rho, method)
            return Bands(low=low, high=high)
    return transform_bands(z, rho, method, axis)


def band_energies(z: torch.Tensor, rho: float, method: Method,
                  axis: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    b = decompose(z, rho, method, axis)
    return (b.low.to(_F32).square().sum(), b.high.to(_F32).square().sum())


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    af = a.to(_F32).ravel()
    bf = b.to(_F32).ravel()
    return torch.dot(af, bf) / torch.clamp(
        torch.linalg.norm(af) * torch.linalg.norm(bf), min=1e-12)
