"""Spectral band split — the FreqCa cache update — as a CUDA kernel.

``band_split_spectral`` is the wrapper of ``csrc/band_split_spectral.cu``
(the port of ``repro.kernels.dct.band_split_spectral``).  It takes CUDA
tensors only; the op layer (``kernels.ops``) sends CPU tensors to the
plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frequency
from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def band_split_spectral(x: torch.Tensor, rho: float, method: str = "dct"):
    """``(low_spec [B, m, D], high [B, S, D])`` of ``x [B, S, D]`` with
    ``m = frequency.spectral_kept_bins(S, rho, method)``; outputs in
    x's type, float32 accumulation."""
    build.require_cuda("band_split_spectral", x)
    if x.ndim != 3:
        raise ValueError(f"band_split_spectral takes [B, S, D], got "
                         f"{tuple(x.shape)}")
    b, s, d = x.shape
    basis = frequency.low_band_basis(s, rho, method, device=x.device)
    m = basis.shape[0]
    low = torch.empty((b, m, d), dtype=x.dtype, device=x.device)
    high = torch.empty_like(x)
    low32 = torch.empty((b, m, d), dtype=torch.float32, device=x.device)
    lib = build.load("band_split_spectral")
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
