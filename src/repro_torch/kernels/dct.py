"""Token-axis band split as CUDA kernels.

* ``band_split_spectral`` wraps ``csrc/band_split_spectral.cu`` (the
  port of ``repro.kernels.dct.band_split_spectral``): the FreqCa cache
  update of the policy objects, two products on the TF32 tensor cores
  to float32 accuracy (``low = B·x``, its reduction over S split in
  slices, then ``high = x − Bᵀ·low``).
* ``token_basis_matmul`` wraps ``csrc/token_basis_matmul.cu`` (the port
  of ``repro.kernels.dct.token_basis_matmul``): ``y = basis @ x`` over
  the token axis, to float32 accuracy on the TF32 tensor cores (the
  float32 basis split into TF32 hi + lo: two products for a bf16 x,
  which TF32 holds exactly, three for a float32 x, split too).
  ``band_split`` applies it with the spatial low-pass projection
  ``L = Cᵀ diag(mask) C`` and writes ``high = x − low`` in the same
  epilogue; ``frequency.decompose`` and ``ops.dct_tokens`` reach it.

The wrappers take CUDA tensors only; the op layer (``kernels.ops``)
sends CPU tensors to the plain versions in ``kernels.ref``.  On ``meta``
tensors they record their work (``spectral_work``, ``basis_work``,
``kernels.meta``) and return empty outputs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import frequency
from repro_torch.kernels import build, meta

_P = ctypes.c_void_p
_I = ctypes.c_int


def spectral_work(b: int, s: int, d: int, m: int, elem: int):
    """``band_split_spectral``'s work, ``({type: FLOP}, bytes)``: its two
    products, ``low = B·x`` and ``Bᵀ·low``, 2·B·m·S·D each, at the TF32
    peak (its arithmetic is float32 on the TF32 tensor cores); x read,
    low and high written (``elem`` bytes an element), the float32 basis
    [m, S] read."""
    return ({"tf32": 2 * (2 * b * m * s * d)},
            2 * b * s * d * elem + b * m * d * elem + m * s * 4)


def basis_work(b: int, s: int, d: int, elem: int, with_high: bool = False):
    """``token_basis_matmul``'s work: the dense product 2·B·S·S·D at the
    TF32 peak; the float32 basis [S, S] and x read, y written (and high,
    ``with_high``, as ``band_split`` launches it)."""
    return ({"tf32": 2 * b * s * s * d},
            s * s * 4 + (3 if with_high else 2) * b * s * d * elem)


def band_split_spectral(x: torch.Tensor, rho: float, method: str = "dct"):
    """``(low_spec [B, m, D], high [B, S, D])`` of ``x [B, S, D]`` with
    ``m = frequency.spectral_kept_bins(S, rho, method)``; outputs in
    x's type, float32 accumulation."""
    build.require_no_grad("band_split_spectral", x)
    if x.ndim != 3:
        raise ValueError(f"band_split_spectral takes [B, S, D], got "
                         f"{tuple(x.shape)}")
    b, s, d = x.shape
    if x.is_meta:
        m = frequency.spectral_kept_bins(s, rho, method)
        return meta.stand_in(
            "band_split_spectral",
            spectral_work(b, s, d, m, x.element_size()),
            torch.empty((b, m, d), dtype=x.dtype, device=x.device),
            torch.empty_like(x))
    build.require_cuda("band_split_spectral", x)
    basis = frequency.low_band_basis(s, rho, method, device=x.device)
    m = basis.shape[0]
    lib = build.load("band_split_spectral")
    slices = lib.band_split_spectral_slices
    slices.argtypes = [_I, _I, _I, _I]
    slices.restype = _I
    low = torch.empty((b, m, d), dtype=x.dtype, device=x.device)
    high = torch.empty_like(x)
    # the float32 partials of pass 1's slices of S; the first ends as
    # the unrounded low band that pass 2 reads
    low32 = torch.empty((slices(b, s, d, m), b, m, d), dtype=torch.float32,
                        device=x.device)
    fn = lib.band_split_spectral
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    status = fn(x.data_ptr(), basis.data_ptr(), low.data_ptr(),
                high.data_ptr(), low32.data_ptr(), b, s, d, m,
                build.dtype_code(x),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "band_split_spectral", status)
    band_split_spectral.launches += 1
    return low, high


band_split_spectral.launches = 0


# unbounded, as frequency's bases are: a multi-resolution deployment
# keeps one projection per (s, rho, method) live (64 MiB of float32 at
# S = 4096), and a bounded cache would rebuild them on every revisit
@functools.lru_cache(maxsize=None)
def _band_split_basis_np(s: int, rho: float, method: str) -> np.ndarray:
    """Low-pass projection ``L = Cᵀ diag(mask) C`` ``[s, s]`` float64
    (symmetric and idempotent).  The kept bins come from
    ``frequency.low_pass_mask_np``.  dct: ``C_keptᵀ C_kept`` over the
    kept rows only.  fft: the circulant real projection
    ``Re(ifft(mask · fft(I)))``, masking the rows of the DFT of the
    identity instead of forming ``diag(mask) @ F`` densely."""
    mask = frequency.low_pass_mask_np(s, rho, method)
    if method == "dct":
        c = frequency._dct_basis_np(s)[mask]
        return c.T @ c
    if method != "fft":
        raise ValueError(f"unknown band-split method {method!r}")
    f = np.fft.fft(np.eye(s), axis=0)
    return np.real(np.fft.ifft(mask[:, None] * f, axis=0))


@functools.lru_cache(maxsize=None)
def _band_split_basis_t(s: int, rho: float, method: str,
                        device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_band_split_basis_np(s, rho, method),
                           dtype=torch.float32, device=device)


def band_split_basis(s: int, rho: float, method: str = "dct",
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """``L: [s, s]`` float32 on ``device`` (cached per device, so the
    hot path never re-uploads it; callers must not write to it)."""
    return _band_split_basis_t(s, rho, method,
                               torch.device(device or "cpu"))


def _basis_matmul(basis: torch.Tensor, x: torch.Tensor, with_high: bool):
    """Launch ``token_basis_matmul``: ``low = basis @ x[b]`` and, with
    ``with_high``, ``high = x − low`` rounded as the reference rounds
    it (after the cast of low to x's type)."""
    build.require_no_grad("token_basis_matmul", basis, x)
    if x.ndim != 3 or basis.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"token_basis_matmul: basis {tuple(basis.shape)} "
                         f"and x {tuple(x.shape)}; expected [S, S] and "
                         "[B, S, D]")
    if basis.dtype != torch.float32:
        raise TypeError("token_basis_matmul: the basis must be float32")
    b, s, d = x.shape
    low = torch.empty_like(x)
    high = torch.empty_like(x) if with_high else None
    if x.is_meta:
        return meta.stand_in("token_basis_matmul",
                             basis_work(b, s, d, x.element_size(), with_high),
                             low, high)
    build.require_cuda("token_basis_matmul", basis, x)
    lib = build.load("token_basis_matmul")
    fn = lib.token_basis_matmul
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    status = fn(basis.data_ptr(), x.data_ptr(), low.data_ptr(),
                None if high is None else high.data_ptr(), b, s, d,
                build.dtype_code(x),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "token_basis_matmul", status)
    token_basis_matmul.launches += 1
    return low, high


def token_basis_matmul(basis: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[b, s, d] = Σ_k basis[s, k]·x[b, k, d]``: basis ``[S, S]``,
    x ``[B, S, D]`` float32 or bf16; float32 accuracy (split TF32
    products, float32 sums), output in x's type."""
    return _basis_matmul(basis.to(torch.float32).contiguous(), x, False)[0]


token_basis_matmul.launches = 0


def band_split(x: torch.Tensor, rho: float, method: str = "dct"):
    """FreqCa band split as one projection product: ``(low, high)`` of
    ``x [B, S, D]`` with ``low = L x`` and ``high = x − low``, both in
    x's type (one ``token_basis_matmul`` launch)."""
    build.require_no_grad("band_split", x)
    if not x.is_meta:
        build.require_cuda("band_split", x)
    basis = band_split_basis(x.shape[-2], rho, method, device=x.device)
    return _basis_matmul(basis, x, True)
