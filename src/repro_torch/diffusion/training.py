"""Rectified-flow training loss for denoisers (counterpart of
``repro.diffusion.training``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.diffusion import schedule


def rf_loss(apply_fn: Callable, params, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, *,
            t: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None):
    """``apply_fn(params, x_t, t) -> velocity``; ``batch["latents"]`` [B,
    H, W, C].  Draws what the reference draws, from ``generator``:
    logit-normal times ``t = sigmoid(N(0, 1))`` [B] (the SD3 / FLUX
    recipe), then ``noise`` in the latents' type.  Either can be passed
    in instead, since the two packages' random streams differ.  Returns
    ``(loss, {"loss": loss})``, the float32 mean squared error of the
    velocity against ``noise − x``."""
    x = batch["latents"]
    if t is None:
        t = torch.sigmoid(torch.randn((x.shape[0],), generator=generator,
                                      device=x.device))
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
    x_t = schedule.add_noise(x, noise, t)
    target = schedule.velocity_target(x, noise)
    v = apply_fn(params, x_t, t)
    loss = torch.mean(torch.square(v.to(torch.float32)
                                   - target.to(torch.float32)))
    return loss, {"loss": loss}
