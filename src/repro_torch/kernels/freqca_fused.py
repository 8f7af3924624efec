"""Fused FreqCa cached steps as CUDA kernels.

* ``freqca_predict_fused_spectral`` wraps ``csrc/freqca_fused_spectral.cu``
  (the port of
  ``repro.kernels.freqca_fused.freqca_predict_fused_spectral``):
  spectral synthesis on the TF32 tensor cores (float32-accurate) plus
  the K-entry Hermite FMA, per lane.
* ``freqca_predict_fused`` wraps ``csrc/freqca_fused.cu`` (the port of
  ``repro.kernels.freqca_fused.freqca_predict_fused``): the legacy
  cached step ``low + Σ_k w_k·hist_k`` over a K-major history with one
  shared ``ts [K]``.

CUDA tensors only; the op layer sends CPU tensors to ``kernels.ref``.
On ``meta`` tensors the wrappers record their work
(``spectral_work`` / ``legacy_work``, ``kernels.meta``) and return an
empty output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hermite
from repro_torch.kernels import build, meta

_P = ctypes.c_void_p
_I = ctypes.c_int


def spectral_work(b: int, k: int, s: int, d: int, m: int, elem: int):
    """``freqca_predict_fused_spectral``'s work, ``({type: FLOP},
    bytes)``: the synthesis 2·B·S·m·D and the K-entry Hermite FMA
    2·B·K·S·D, at the TF32 peak; low_spec, the ring and the output
    (``elem`` bytes an element), the float32 basis [S, m] and weights
    [B, K]."""
    return ({"tf32": 2 * b * s * m * d + 2 * b * k * s * d},
            (b * m * d + b * k * s * d + b * s * d) * elem
            + (s * m + b * k) * 4)


def legacy_work(k: int, n: int, elem: int, op_dtype: str):
    """``freqca_predict_fused``'s work on ``n`` elements of the feature:
    2·K FLOP an element in ``op_dtype``; low, the K-entry history and
    the output once, and the K float32 weights."""
    return {op_dtype: 2 * k * n}, (k + 2) * n * elem + k * 4


def freqca_predict_fused_spectral(low_spec: torch.Tensor,
                                  synth: torch.Tensor,
                                  high_hist: torch.Tensor,
                                  w: torch.Tensor) -> torch.Tensor:
    """ẑ = synth·low_spec + Σ_k w[:, k]·high_hist[:, k], one pass.

    low_spec [B, m, D]; synth [S, m] (``low_band_basis(S).T``);
    high_hist [B, K, S, D] in ring-slot order, of low_spec's type;
    w [B, K] per-lane folded Hermite weights.  Output [B, S, D] in
    high_hist's type.  The kernel reads synth's transpose, S-contiguous:
    for the view ``basis.T`` that is the basis itself, with no copy.
    """
    build.require_no_grad("freqca_predict_fused_spectral", low_spec, synth,
                          high_hist, w)
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
    basis = synth.to(torch.float32).T.contiguous()     # [m, S]
    w = w.to(torch.float32).contiguous()
    out = torch.empty((b, s, d), dtype=high_hist.dtype,
                      device=high_hist.device)
    if out.is_meta:
        return meta.stand_in("freqca_predict_fused_spectral", spectral_work(
            b, k, s, d, m, high_hist.element_size()), out)
    build.require_cuda("freqca_predict_fused_spectral", low_spec, basis,
                       high_hist, w)
    lib = build.load("freqca_fused_spectral")
    fn = lib.freqca_fused_spectral
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    status = fn(low_spec.data_ptr(), basis.data_ptr(), high_hist.data_ptr(),
                w.data_ptr(), out.data_ptr(), b, k, s, d, m,
                build.dtype_code(high_hist),
                torch.cuda.current_stream(out.device).cuda_stream)
    build.check(lib, "freqca_predict_fused_spectral", status)
    freqca_predict_fused_spectral.launches += 1
    return out


freqca_predict_fused_spectral.launches = 0


def hermite_eval_weights(ts: torch.Tensor, t_query,
                         order: int) -> torch.Tensor:
    """Weights w with prediction = Σ_k w_k·hist_k — an alias of
    :func:`repro_torch.core.hermite.eval_weights`, so the folded kernel
    path and the explicit fit share one normal-equation setup."""
    return hermite.eval_weights(ts, t_query, order)


def freqca_predict_fused(low: torch.Tensor, high_hist: torch.Tensor,
                         ts: torch.Tensor, t_query,
                         order: int) -> torch.Tensor:
    """ẑ = low + Hermite(high_hist)(t_query), one pass.

    low ``[B, S, D]``; high_hist ``[K, B, S, D]`` of low's type; ts
    ``[K]``.  The K folded weights stay a float32 tensor on the device
    (no host read); float32 accumulation, output in low's type.
    """
    build.require_no_grad("freqca_predict_fused", low, high_hist, ts,
                          t_query)
    if tuple(ts.shape) != (high_hist.shape[0],):
        raise ValueError(f"freqca_predict_fused: ts {tuple(ts.shape)} for "
                         f"a history of {high_hist.shape[0]}")
    if not low.is_meta:
        build.require_cuda("freqca_predict_fused", low, high_hist)
    w = hermite_eval_weights(ts.to(low.device), t_query, order)
    return launch_fused(low, high_hist, w)


def launch_fused(low: torch.Tensor, high_hist: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """The kernel launch of ``freqca_predict_fused`` with the folded
    weights ``w [K]`` already on the device: low + Σ_k w_k·high_hist_k."""
    build.require_no_grad("freqca_predict_fused", low, high_hist, w)
    k = high_hist.shape[0]
    if high_hist.shape[1:] != low.shape or tuple(w.shape) != (k,):
        raise ValueError(
            f"freqca_predict_fused: low {tuple(low.shape)}, high_hist "
            f"{tuple(high_hist.shape)}, w {tuple(w.shape)}")
    if low.dtype != high_hist.dtype:
        raise TypeError("low and high_hist must share one type")
    w = w.to(torch.float32).contiguous()
    out = torch.empty_like(low)
    if out.is_meta:
        dt = "float32" if low.dtype == torch.float32 else "bfloat16"
        return meta.stand_in("freqca_predict_fused", legacy_work(
            k, low.numel(), low.element_size(), dt), out)
    build.require_cuda("freqca_predict_fused", low, high_hist, w)
    lib = build.load("freqca_fused")
    fn = lib.freqca_fused
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_long, _I, _I, _P]
    fn.restype = _I
    status = fn(low.data_ptr(), high_hist.data_ptr(), w.data_ptr(),
                out.data_ptr(), low.numel(), k, build.dtype_code(low),
                torch.cuda.current_stream(low.device).cuda_stream)
    build.check(lib, "freqca_predict_fused", status)
    freqca_predict_fused.launches += 1
    return out


freqca_predict_fused.launches = 0
