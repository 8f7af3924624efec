"""FORA baseline: whole-feature reuse, an order-0 cache (counterpart of
``repro.core.policies.fora``).  Cached steps replay the CRF of the most
recent activated step unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.policies import base, registry
from repro_torch.core.policies.taylorseer import ForecastState


@dataclasses.dataclass(frozen=True)
class ForaPolicy(base.Policy):
    name = "fora"

    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=torch.float32, device=None, **_):
        return ForecastState(
            hist=base.ring_init(batch, 1, feat_shape, crf_dtype, device),
            n_valid=torch.zeros((batch,), dtype=torch.int32, device=device))

    def update(self, state, crf, ctx):
        return ForecastState(
            hist=base.ring_push(state.hist, crf, ctx.t_now),
            n_valid=state.n_valid + 1)

    def predict(self, state, ctx):
        return base.ring_last(state.hist)


@registry.register("fora")
def _from_spec(spec) -> ForaPolicy:
    return ForaPolicy(interval=spec.interval)
