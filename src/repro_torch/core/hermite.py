"""Hermite-polynomial trajectory predictor (paper §3.2, strategy 2).

Counterpart of ``repro.core.hermite``: each high-frequency coefficient
is fitted by least squares in probabilists' Hermite polynomials over
the K most recent activated steps, and the fit folds into K scalar
weights ``w = B G⁻¹ b_q`` so prediction is one FMA over the history.
All arithmetic is float32, as in the reference.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


def hermite_basis(s: torch.Tensor, order: int) -> torch.Tensor:
    """He_0..He_order at s -> [..., order+1] (He_{k+1} = s·He_k − k·He_{k−1})."""
    s = s.to(_F32)
    cols = [torch.ones_like(s)]
    if order >= 1:
        cols.append(s)
    for k in range(1, order):
        cols.append(s * cols[-1] - k * cols[-2])
    return torch.stack(cols, dim=-1)


def normalize_times(ts: torch.Tensor, t_query) -> torch.Tensor:
    """Map times so the cached history spans [-1, 0] and extrapolation
    targets land just beyond.  ``ts: [..., K]``; reduces over the last
    axis (batched over lanes)."""
    ts = ts.to(_F32)
    lo = ts.amin(dim=-1, keepdim=True)
    hi = ts.amax(dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    tq = torch.as_tensor(t_query, dtype=_F32, device=ts.device)
    if tq.ndim == ts.ndim:
        return (tq - hi) / span
    return ((tq[..., None] - hi) / span)[..., 0]


def normal_system(ts: torch.Tensor, order: int):
    """``(basis [..., K, m+1], g [..., m+1, m+1])`` with the 1e-6
    Tikhonov jitter of the reference."""
    s = normalize_times(ts, ts)                           # [..., K]
    basis = hermite_basis(s, order)                       # [..., K, m+1]
    eye = torch.eye(order + 1, dtype=_F32, device=ts.device)
    g = basis.transpose(-1, -2) @ basis + 1e-6 * eye
    return basis, g


def fit_coefficients(ts: torch.Tensor, values: torch.Tensor,
                     order: int) -> torch.Tensor:
    """Least-squares Hermite fit: ``ts [K]``, ``values [K, ...]`` ->
    coefficients ``[order+1, ...]``.  The shapes are kept (no flatten)
    and the solve only moves axes, as in the reference."""
    basis, g = normal_system(ts, order)
    rhs = torch.einsum("km,k...->m...", basis, values.to(_F32))
    if rhs.ndim == 1:
        return torch.linalg.solve(g, rhs)
    coeffs = torch.linalg.solve(g, torch.movedim(rhs, 0, -2))
    return torch.movedim(coeffs, -2, 0)


def eval_weights(ts: torch.Tensor, t_query, order: int) -> torch.Tensor:
    """Weights w st. prediction = Σ_k w_k · hist_k.  ``ts: [..., K]``
    -> ``[..., K]`` (one fold per leading index, e.g. per lane)."""
    basis, g = normal_system(ts, order)
    s_q = normalize_times(ts, t_query)                    # [...]
    basis_q = hermite_basis(s_q, order)                   # [..., m+1]
    # solve_ex: no device-to-host error check on the hot path (G is
    # SPD by construction: BᵀB plus the jitter)
    sol, _ = torch.linalg.solve_ex(g, basis_q[..., None])
    return (basis @ sol)[..., 0]


def predict(ts: torch.Tensor, values: torch.Tensor, t_query,
            order: int) -> torch.Tensor:
    """Fit on ``(ts [K], values [K, ...])`` and evaluate at ``t_query``."""
    w = eval_weights(ts, t_query, order)
    out = torch.tensordot(w, values.to(_F32), dims=([0], [0]))
    return out.to(values.dtype)


def predict_from_coeffs(coeffs: torch.Tensor, ts: torch.Tensor, t_query,
                        order: int) -> torch.Tensor:
    """Evaluate fitted coefficients ``[order+1, ...]`` at ``t_query``."""
    basis_q = hermite_basis(normalize_times(ts, t_query), order)
    return torch.einsum("m,m...->...", basis_q, coeffs.to(_F32))
