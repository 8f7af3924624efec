"""Op layer: one entry per kernel, dispatched by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``); a CUDA
tensor goes to the hand-written kernel, which raises if it cannot take
the call.  No environment variable or flag can send a CUDA tensor to the
plain version: a switch like that would hide the kernel on the very
path it exists for.  (The reference reads ``REPRO_KERNELS`` because
XLA on a CPU and Pallas on a TPU are both legitimate backends there.)

A ``meta`` tensor takes the CUDA route: the wrapper records the kernel's
work and launches nothing (``kernels.meta``; the dry run).

Each kernel wrapper counts its own launches (``<wrapper>.launches``);
``launch_counts`` / ``reset_launch_counts`` read and clear them.

Gradients: on CUDA, ``flash`` and ``ssd`` are ``torch.autograd.Function``s
whose backwards are kernels too (the flash backward, the SSD-scan
backward); the other kernels have no backward, and their wrappers raise
when autograd would need one (so does the raw SSD-scan wrapper, called
under grad outside its Function).  On the CPU, autograd differentiates
the plain versions.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import frequency, hermite
from repro_torch.kernels import (dct, flash_attention, freqca_fused, ref,
                                 ssd_scan)

_WRAPPERS = {
    "band_split_spectral": dct.band_split_spectral,
    "freqca_predict_fused_spectral":
        freqca_fused.freqca_predict_fused_spectral,
    "flash_attention": flash_attention.flash_attention,
    "flash_attention_bwd": flash_attention.flash_attention_bwd,
    "token_basis_matmul": dct.token_basis_matmul,
    "freqca_predict_fused": freqca_fused.freqca_predict_fused,
    "ssd_chunk_scan": ssd_scan.ssd_chunk_scan,
    "ssd_chunk_scan_bwd": ssd_scan.ssd_chunk_scan_bwd,
    "flash_attention_f32": flash_attention.flash_attention_f32,
    "flash_attention_f32_bwd": flash_attention.flash_attention_f32_bwd,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def _on_cuda(t: torch.Tensor) -> bool:
    """The kernel route: a CUDA tensor, or a ``meta`` one, which stands
    for the card's in the dry run (the kernel records its work,
    ``kernels.meta``)."""
    return t.device.type in ("cuda", "meta")


def dct_tokens(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the token axis of ``[B, S, D]`` (the
    DCT-II basis through ``token_basis_matmul``)."""
    basis = frequency.dct_basis(x.shape[-2], device=x.device)
    if _on_cuda(x):
        return dct.token_basis_matmul(basis, x.contiguous())
    return ref.token_basis_matmul_ref(basis, x)


def band_split(x: torch.Tensor, rho: float = 0.0625, method: str = "dct"):
    """FreqCa band split ``(low, high)`` of ``[B, S, D]`` as one
    projection product (``frequency.decompose``'s kernel route)."""
    if _on_cuda(x):
        return dct.band_split(x.contiguous(), rho, method)
    return ref.band_split_ref(x, rho, method)


def freqca_predict(low: torch.Tensor, high_hist: torch.Tensor,
                   ts: torch.Tensor, t_query, order: int = 2) -> torch.Tensor:
    """Fused legacy cached step: ẑ = low + Hermite(high_hist)(t) with
    low ``[B, S, D]``, a K-major high_hist ``[K, B, S, D]`` and ts
    ``[K]``."""
    if _on_cuda(high_hist):
        return freqca_fused.freqca_predict_fused(
            low.contiguous(), high_hist.contiguous(), ts, t_query, order)
    return ref.freqca_predict_ref(low, high_hist, ts, t_query, order)


def band_split_spectral(x: torch.Tensor, rho: float = 0.0625,
                        method: str = "dct"):
    """Spectral band split: ``(low_spec [B, m, D], high [B, S, D])``."""
    if _on_cuda(x):
        return dct.band_split_spectral(x.contiguous(), rho, method)
    return ref.band_split_spectral_ref(x, rho, method)


def freqca_predict_spectral(low_spec: torch.Tensor, synth: torch.Tensor,
                            high_hist: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Fused spectral cached step: synth·low_spec + Σ_k w[:, k]·high_k."""
    if _on_cuda(high_hist):
        return freqca_fused.freqca_predict_fused_spectral(
            low_spec.contiguous(), synth, high_hist.contiguous(), w)
    return ref.freqca_predict_spectral_ref(low_spec, synth, high_hist, w)


def hermite_weights(ts: torch.Tensor, t_query, order: int) -> torch.Tensor:
    """Per-lane folded Hermite weights ``[B, K]`` from ``ts [B, K]`` —
    the tiny normal-equation solves stay plain torch ops."""
    return hermite.eval_weights(ts, t_query, order)


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward keeps
    ``q, k, v``, the output and the row log-sum-exp only when a gradient
    is needed; the backward recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, q_per_kv: int, causal: bool, window: int):
        ctx.form = (q_per_kv, causal, window)
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention.flash_attention(q, k, v, q_per_kv, causal,
                                                   window)
        out, lse = flash_attention.flash_attention(
            q, k, v, q_per_kv, causal, window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention.flash_attention_bwd(
            q, k, v, out, lse, d_out.contiguous(), *ctx.form)
        return dq, dk, dv, None, None, None


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_per_kv: int = 1, causal: bool = False,
          window: int = 0) -> torch.Tensor:
    """Attention over ``q [B, S, Hq, hd]``, ``k, v [B, T, Hkv, hd]``:
    non-causal MHA for the DiT's joint attention; causal, windowed and
    GQA for the LM's self-attention.  Differentiable on both devices."""
    if _on_cuda(q):
        return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                      v.contiguous(), q_per_kv, causal,
                                      window)
    return ref.attention_ref(q, k, v, q_per_kv, causal, window)


class SSDChunkScanFn(torch.autograd.Function):
    """The SSD scan kernel with its backward kernel: the forward keeps
    its inputs only, and only when a gradient is needed; the backward
    reruns the forward's first passes from them."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.chunk = chunk
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, dt, A, B, C)
        return ssd_scan.ssd_chunk_scan(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C = ctx.saved_tensors
        grads = ssd_scan.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, ctx.chunk)
        return (*(g if need else None for g, need in
                  zip(grads, ctx.needs_input_grad[:5], strict=True)), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Mamba2 SSD chunk scan ``y [b, s, h, p]`` (no D-skip): ``x [b, s,
    h, p]``, ``dt [b, s, h]``, ``A [h]``, ``B, C [b, s, n]``.  The kernel
    reads x, B and C through their strides (they are column slices of
    the block's conv output).  Differentiable on both devices."""
    if _on_cuda(x):
        return SSDChunkScanFn.apply(x, dt.float(), A.float(), B, C, chunk)
    return ref.ssd_chunk_scan_ref(x, dt, A, B, C, chunk)
