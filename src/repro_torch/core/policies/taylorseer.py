"""TaylorSeer baseline: whole-feature polynomial forecast, no bands
(counterpart of ``repro.core.policies.taylorseer``).

The paper's main forecast baseline: an order-``high_order`` Hermite
extrapolation of the whole CRF from the ``high_order + 1`` most recent
activated steps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.policies import base, registry


class ForecastState(NamedTuple):
    hist: base.Ring                # [B, K, *feat] whole-feature history
    n_valid: torch.Tensor          # [B] int32


@dataclasses.dataclass(frozen=True)
class TaylorSeerPolicy(base.Policy):
    name = "taylorseer"

    high_order: int = 2

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
             crf_dtype=torch.float32, device=None, **_):
        return ForecastState(
            hist=base.ring_init(batch, self.k_high, feat_shape, crf_dtype,
                                device),
            n_valid=torch.zeros((batch,), dtype=torch.int32, device=device))

    def update(self, state, crf, ctx):
        return ForecastState(
            hist=base.ring_push(state.hist, crf, ctx.t_now),
            n_valid=state.n_valid + 1)

    def predict(self, state, ctx):
        return base.ring_predict(state.hist, ctx.t_now, self.high_order)


@registry.register("taylorseer")
def _from_spec(spec) -> TaylorSeerPolicy:
    return TaylorSeerPolicy(interval=spec.interval,
                            high_order=spec.high_order)
