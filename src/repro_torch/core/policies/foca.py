"""FoCa-style forecast-then-calibrate policy (cf. arXiv 2508.16211;
counterpart of ``repro.core.policies.foca``).

Forecast: TaylorSeer's Hermite extrapolation of the whole CRF.
Calibrate: at every activated step the stale forecast for that step is
scored against the fresh CRF and a per-lane gain
``γ = ⟨forecast, crf⟩ / ||forecast||²``, clipped to
``[1/calib_clip, calib_clip]``, scales later cached-step forecasts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.policies import base, registry

_F32 = torch.float32


class FoCaState(NamedTuple):
    hist: base.Ring                # [B, K, *feat]
    n_valid: torch.Tensor          # [B] int32
    gain: torch.Tensor             # [B] f32 calibration gain


@dataclasses.dataclass(frozen=True)
class FoCaPolicy(base.Policy):
    name = "foca"

    high_order: int = 2
    calib_clip: float = 2.0        # gain clipped to [1/clip, clip]

    @property
    def k_high(self) -> int:
        return self.high_order + 1

    @property
    def needed_history(self) -> int:
        return self.k_high

    @property
    def cache_units(self) -> int:
        return self.k_high

    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=_F32, device=None, **_):
        return FoCaState(
            hist=base.ring_init(batch, self.k_high, feat_shape, crf_dtype,
                                device),
            n_valid=torch.zeros((batch,), dtype=torch.int32, device=device),
            gain=torch.ones((batch,), dtype=_F32, device=device))

    def update(self, state, crf, ctx):
        # the forecast is taken before the in-place push below
        pred = base.ring_predict(state.hist, ctx.t_now, self.high_order)
        axes = tuple(range(1, crf.ndim))
        p, c = pred.to(_F32), crf.to(_F32)
        g = (p * c).sum(dim=axes) / ((p * p).sum(dim=axes) + 1e-6)
        g = torch.clamp(g, 1.0 / self.calib_clip, self.calib_clip)
        # calibrate only once the ring is full: earlier forecasts are fit
        # on zero-padded history and would poison the gain
        gain = torch.where(state.n_valid >= self.needed_history, g, 1.0)
        return FoCaState(hist=base.ring_push(state.hist, crf, ctx.t_now),
                         n_valid=state.n_valid + 1, gain=gain)

    def predict(self, state, ctx):
        pred = base.ring_predict(state.hist, ctx.t_now, self.high_order)
        g = state.gain.reshape(state.gain.shape + (1,) * (pred.ndim - 1))
        return (g * pred.to(_F32)).to(pred.dtype)


@registry.register("foca")
def _from_spec(spec) -> FoCaPolicy:
    return FoCaPolicy(interval=spec.interval, high_order=spec.high_order)
