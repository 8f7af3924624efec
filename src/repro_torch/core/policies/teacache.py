"""TeaCache-style adaptive reuse with per-lane activation (counterpart
of ``repro.core.policies.teacache``).

Each lane accumulates the relative change of its own model input
``x_t`` between steps and runs a full forward when the accumulator
crosses ``tea_threshold`` (the interval schedule is ignored); the
prediction is reuse, as in FORA.  The accumulator and the previous input
are policy state, and every lane resets on its own.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.policies import base, registry

_F32 = torch.float32


class TeaCacheState(NamedTuple):
    hist: base.Ring                # [B, 1, *feat] last full CRF
    n_valid: torch.Tensor          # [B] int32
    acc: torch.Tensor              # [B] f32 accumulated relative change
    prev_x: torch.Tensor           # [B, *latent] previous model input


@dataclasses.dataclass(frozen=True)
class TeaCachePolicy(base.Policy):
    name = "teacache"
    per_lane = True

    tea_threshold: float = 0.15

    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=_F32, latent_shape: Tuple[int, ...] = (),
             latent_dtype=_F32, device=None):
        return TeaCacheState(
            hist=base.ring_init(batch, 1, feat_shape, crf_dtype, device),
            n_valid=torch.zeros((batch,), dtype=torch.int32, device=device),
            acc=torch.zeros((batch,), dtype=_F32, device=device),
            prev_x=torch.zeros((batch,) + tuple(latent_shape),
                               dtype=latent_dtype, device=device))

    def decide(self, state, ctx):
        rel = base.lane_mean_abs(ctx.x - state.prev_x) / torch.clamp(
            base.lane_mean_abs(state.prev_x), min=1e-6)
        acc = state.acc + rel
        act = ((state.n_valid < 1) | (acc > self.tea_threshold)
               | (ctx.step_idx == 0))
        return state._replace(
            acc=torch.where(act, 0.0, acc),
            prev_x=ctx.x.to(state.prev_x.dtype)), act

    def update(self, state, crf, ctx):
        return state._replace(
            hist=base.ring_push(state.hist, crf, ctx.t_now),
            n_valid=state.n_valid + 1)

    def predict(self, state, ctx):
        return base.ring_last(state.hist)


@registry.register("teacache")
def _from_spec(spec) -> TeaCachePolicy:
    return TeaCachePolicy(interval=spec.interval,
                          tea_threshold=spec.tea_threshold)
