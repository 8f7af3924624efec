"""Fused FreqCa cached step — spectral synthesis plus the K-entry
Hermite FMA — as a CUDA kernel.

``freqca_predict_fused_spectral`` is the wrapper of
``csrc/freqca_fused_spectral.cu`` (the port of
``repro.kernels.freqca_fused.freqca_predict_fused_spectral``).  CUDA
tensors only; the op layer sends CPU tensors to ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def freqca_predict_fused_spectral(low_spec: torch.Tensor,
                                  synth: torch.Tensor,
                                  high_hist: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    """ẑ = synth·low_spec + Σ_k w[:, k]·high_hist[:, k], one pass.

    low_spec [B, m, D]; synth [S, m] (``low_band_basis(S).T``);
    high_hist [B, K, S, D] in ring-slot order, of low_spec's type;
    w [B, K] per-lane folded Hermite weights.  Output [B, S, D] in
    high_hist's type.
    """
    b, k, s, d = high_hist.shape
    m = synth.shape[1]
    if low_spec.shape != (b, m, d) or synth.shape != (s, m) \
            or w.shape != (b, k):
        raise ValueError(
            "freqca_predict_fused_spectral: shapes disagree: low_spec "
            f"{tuple(low_spec.shape)}, synth {tuple(synth.shape)}, "
            f"high_hist {tuple(high_hist.shape)}, w {tuple(w.shape)}")
    if low_spec.dtype != high_hist.dtype:
        raise TypeError("low_spec and high_hist must share one type")
    synth = synth.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    build.require_cuda("freqca_predict_fused_spectral", low_spec, synth,
                       high_hist, w)
    out = torch.empty((b, s, d), dtype=high_hist.dtype,
                      device=high_hist.device)
    lib = build.load("freqca_fused_spectral")
    fn = lib.freqca_fused_spectral
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    status = fn(low_spec.data_ptr(), synth.data_ptr(), high_hist.data_ptr(),
                w.data_ptr(), out.data_ptr(), b, k, s, d, m,
                build.dtype_code(high_hist),
                torch.cuda.current_stream(out.device).cuda_stream)
    build.check(lib, "freqca_predict_fused_spectral", status)
    freqca_predict_fused_spectral.launches += 1
    return out


freqca_predict_fused_spectral.launches = 0
