"""Rectified-flow schedule (FLUX/Qwen-Image family).

Forward process: x_t = (1 - t)·x_data + t·noise, t ∈ [0, 1]; the model
predicts velocity v = noise − x_data, and sampling integrates dx/dt = v
from t=1 (noise) to t=0 (data) with Euler steps.
"""
from __future__ import annotations

import torch


def timesteps(n_steps: int, shift: float = 1.0,
              device=None) -> torch.Tensor:
    """Decreasing float32 times t_0=1 … t_N=0 (N+1 knots for N steps).

    The knots are ``1 + i·(−1/N)`` in float32 with the last one exactly
    0, which is how ``jnp.linspace`` forms them, so both packages step
    through bit-equal times.  ``shift`` > 1 spends more steps near t=1.
    """
    i = torch.arange(n_steps + 1, dtype=torch.float32, device=device)
    u = 1.0 + i * torch.tensor(-1.0 / n_steps, dtype=torch.float32,
                               device=device)
    u[-1] = 0.0
    return (shift * u) / (1.0 + (shift - 1.0) * u)


def add_noise(x_data: torch.Tensor, noise: torch.Tensor,
              t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=x_data.dtype, device=x_data.device)
    while t.ndim < x_data.ndim:
        t = t[..., None]
    return (1.0 - t) * x_data + t * noise


def velocity_target(x_data: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    return noise - x_data
