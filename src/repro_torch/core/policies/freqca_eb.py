"""FreqCa-EB: error-budgeted, feedback-driven activation (counterpart of
``repro.core.policies.freqca_eb``).

On every full step the low ring already holds the spectral coefficients
the lane would have served, so scoring them against the fresh split
costs one subtraction in the spectral basis.  The measured per-band
error rate is carried as policy state and *spent* against a budget:

* each cached step spends ``rate = rate_low + rate_high`` from the
  accumulator (``acc``);
* a full forward fires as an **event** exactly when the next cached
  step would overspend (``acc + rate > budget``), resetting ``acc``;
* the full step re-measures both band rates (``observe``).

``with_budget(max_error)`` snaps a request's ``max_error`` down to a
tier of ``ERROR_TIERS``; the tier is a dataclass field, so it folds into
``compatibility_key`` and requests group by (policy, tier).  The peak
accumulator value is reported per lane through ``error_feedback``.

``measure_error`` splits the fresh CRF through the policy's ``_split``
(the band-split kernel on the card), so a full step of an EB lane
splits its CRF twice: once here, once in ``update`` — the reference's
order, with no state carried between the two hooks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.policies import base, registry
from repro_torch.core.policies.freqca import FreqCaPolicy

_F32 = torch.float32

# Budget quantization ladder: a requested max_error snaps DOWN to the
# nearest tier (never promising less quality than asked), so at most
# len(ERROR_TIERS) compatibility groups exist.
ERROR_TIERS: Tuple[float, ...] = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)


def budget_tier(max_error: float) -> float:
    """Largest tier <= max_error (strictest tier when below them all)."""
    eligible = [t for t in ERROR_TIERS if t <= max_error + 1e-12]
    return eligible[-1] if eligible else ERROR_TIERS[0]


class FreqCaEbState(NamedTuple):
    low: base.Ring                 # [B, K_low, m, D] SPECTRAL low band
    high: base.Ring                # [B, K_high, *feat] spatial high band
    n_valid: torch.Tensor          # [B] int32 — activated steps per lane
    rate_low: torch.Tensor         # [B] f32 — low-band error rate
    rate_high: torch.Tensor        # [B] f32 — high-band error rate
    acc: torch.Tensor              # [B] f32 — error spent since last full
    peak: torch.Tensor             # [B] f32 — max inter-full spend (SLO)
    events: torch.Tensor           # [B] int32 — budget-triggered fulls


@dataclasses.dataclass(frozen=True)
class FreqCaErrorBudgetPolicy(FreqCaPolicy):
    name = "freqca_eb"
    per_lane = True
    uses_error_feedback = True

    budget: float = 0.1            # max error accumulated between fulls

    def with_budget(self, max_error: Optional[float]) -> "FreqCaPolicy":
        if max_error is None:
            return self
        return dataclasses.replace(self, budget=budget_tier(max_error))

    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=_F32, device=None, **_):
        st = super().init(batch, feat_shape, crf_dtype, device=device)

        def zf():
            return torch.zeros((batch,), dtype=_F32, device=device)
        return FreqCaEbState(
            low=st.low, high=st.high, n_valid=st.n_valid,
            rate_low=zf(), rate_high=zf(), acc=zf(), peak=zf(),
            events=torch.zeros((batch,), dtype=torch.int32, device=device))

    def decide(self, state, ctx):
        # +1: one calibration full past the predictor's warm-up, so the
        # first adaptive skip rests on a measurement from a full ring
        warm = state.n_valid < self.needed_history + 1
        spend = state.acc + (state.rate_low + state.rate_high)
        act = warm | (spend > self.budget)
        # the sampler commits to this mask, so the bookkeeping lands
        # here: a cached lane spends, an activated lane resets
        acc = torch.where(act, torch.zeros_like(spend), spend)
        return state._replace(
            acc=acc, peak=torch.maximum(state.peak, acc),
            events=state.events + (act & ~warm).to(torch.int32)), act

    def measure_error(self, state, crf, ctx):
        """Per-band prediction error vs the fresh CRF -> [B, 2] float32.

        The low ring entry is scored against the fresh spectral
        coefficients (the basis is orthonormal, so spectral L2 equals
        spatial L2), the high Hermite forecast against the fresh
        spatial high band; both over the whole-feature norm, so the two
        rates add up to a bound on the full relative error.
        """
        low_spec, high = self._split(crf)
        low_pred = self._low_coeffs(state, ctx)
        high_pred = (base.ring_last(state.high) if self.high_order == 0
                     else base.ring_predict(state.high, ctx.t_now,
                                            self.high_order))

        def sq(x):
            x = x.to(_F32)
            return x.square().sum(dim=tuple(range(1, x.ndim)))

        den = torch.sqrt(torch.clamp(sq(low_spec) + sq(high), min=1e-12))
        e_low = torch.sqrt(sq(low_pred.to(_F32) - low_spec.to(_F32))) / den
        e_high = torch.sqrt(sq(high_pred.to(_F32) - high.to(_F32))) / den
        # warm lanes predict from underfilled rings: not a measurement.
        # (where, not the reference's product with the 0/1 mask: the
        # forecast from an unfilled ring may be non-finite, and 0·inf
        # would leak a NaN; finite values come out equal)
        valid = (state.n_valid >= self.needed_history)[:, None]
        err = torch.stack([e_low, e_high], dim=-1)
        return torch.where(valid, err, torch.zeros_like(err))

    def observe(self, state, realized_error, ctx):
        return state._replace(rate_low=realized_error[:, 0],
                              rate_high=realized_error[:, 1])

    def error_feedback(self, state):
        return base.ErrorFeedback(realized=state.peak, events=state.events)


@registry.register("freqca_eb")
def _from_spec(spec) -> FreqCaErrorBudgetPolicy:
    # legacy specs carry no budget field; reuse the adaptive threshold
    return FreqCaErrorBudgetPolicy(
        interval=spec.interval, method=spec.method, rho=spec.rho,
        low_order=spec.low_order, high_order=spec.high_order,
        token_axis=spec.token_axis, budget=budget_tier(spec.tea_threshold))
