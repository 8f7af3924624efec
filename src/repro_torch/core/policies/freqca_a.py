"""FreqCa-A: the FreqCa predictor with a self-calibrated adaptive
schedule, per lane (counterpart of ``repro.core.policies.freqca_a``).

At every activated step the cache already holds what FreqCa would have
predicted for that step, so its relative error against the fresh CRF is
free to measure.  A lane then skips while the projected error of the
next cached step, ``(steps_since_full + 1) · err_last``, stays under
``tea_threshold``.  It subclasses the port's ``FreqCaPolicy``, so its
update and prediction run the same spectral kernels.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.policies import base, registry
from repro_torch.core.policies.freqca import FreqCaPolicy

_F32 = torch.float32


class FreqCaAState(NamedTuple):
    low: base.Ring                 # [B, K_low, m, D] SPECTRAL low band
    high: base.Ring                # [B, K_high, *feat]
    n_valid: torch.Tensor          # [B] int32
    since: torch.Tensor            # [B] int32 — steps since last full
    err_last: torch.Tensor         # [B] f32 — last measured pred error


@dataclasses.dataclass(frozen=True)
class FreqCaAdaptivePolicy(FreqCaPolicy):
    name = "freqca_a"
    per_lane = True

    tea_threshold: float = 0.15

    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=_F32, device=None, **_):
        feat_shape = tuple(feat_shape)
        return FreqCaAState(
            low=base.ring_init(batch, self.k_low,
                               self.low_feat_shape(feat_shape), crf_dtype,
                               device),
            high=base.ring_init(batch, self.k_high, feat_shape, crf_dtype,
                                device),
            n_valid=torch.zeros((batch,), dtype=torch.int32, device=device),
            since=torch.zeros((batch,), dtype=torch.int32, device=device),
            err_last=torch.zeros((batch,), dtype=_F32, device=device))

    def decide(self, state, ctx):
        warm = state.n_valid < self.needed_history
        projected = (state.since.to(_F32) + 1.0) * state.err_last
        act = warm | (projected > self.tea_threshold)
        # the sampler commits to this mask, so the skip counter resets
        # here; update() runs only on the activated lanes
        return state._replace(
            since=torch.where(act, 0, state.since + 1)), act

    def update(self, state, crf, ctx):
        # score the prediction FreqCa would have made for THIS step
        # against the fresh CRF, before the in-place pushes below
        err = base.lane_rel_norm(self.predict(state, ctx), crf)
        low_spec, high = self._split(crf)
        return state._replace(
            low=base.ring_push(state.low, low_spec, ctx.t_now),
            high=base.ring_push(state.high, high, ctx.t_now),
            n_valid=state.n_valid + 1,
            err_last=err)


@registry.register("freqca_a")
def _from_spec(spec) -> FreqCaAdaptivePolicy:
    return FreqCaAdaptivePolicy(interval=spec.interval, method=spec.method,
                                rho=spec.rho, low_order=spec.low_order,
                                high_order=spec.high_order,
                                token_axis=spec.token_axis,
                                tea_threshold=spec.tea_threshold)
