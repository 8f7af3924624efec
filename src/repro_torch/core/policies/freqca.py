"""FreqCa (the paper's policy): frequency-split CRF caching with a
spectral low-band ring (counterpart of ``repro.core.policies.freqca``).

The CRF splits into a low band held as ``m = spectral_kept_bins(S, rho,
method)`` coefficient rows and a spatial high band forecast with an
order-``high_order`` Hermite fit over the ``k_high`` most recent
activated steps.  Both halves go through the op layer: on CUDA
``update`` is the band-split kernel and ``predict`` the fused
synthesis + Hermite kernel; on the CPU their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import frequency
from repro_torch.core.policies import base, registry
from repro_torch.kernels import ops

_F32 = torch.float32


class FreqCaState(NamedTuple):
    low: base.Ring                 # [B, K_low, m, D] SPECTRAL low band
    high: base.Ring                # [B, K_high, *feat] spatial high band
    n_valid: torch.Tensor          # [B] int32 — activated steps per lane


@dataclasses.dataclass(frozen=True)
class FreqCaPolicy(base.Policy):
    name = "freqca"

    method: str = "dct"            # fft | dct | none
    rho: float = 0.0625            # low-frequency fraction of the spectrum
    low_order: int = 0             # 0 = direct reuse (paper default)
    high_order: int = 2            # Hermite order for the high band
    token_axis: int = 1            # token axis of the per-lane [B, S, D] CRF

    @property
    def k_low(self) -> int:
        return self.low_order + 1

    @property
    def k_high(self) -> int:
        return self.high_order + 1

    @property
    def needed_history(self) -> int:
        return max(self.k_low, self.k_high)

    @property
    def cache_units(self) -> int:
        return self.k_low + self.k_high

    # --- spectral layout --------------------------------------------------
    def spectral_bins(self, s: int) -> int:
        return frequency.spectral_kept_bins(s, self.rho, self.method)

    def low_feat_shape(self, feat_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Per-lane low-ring shape: the token axis shrinks S -> m."""
        ax = self.token_axis - 1
        return feat_shape[:ax] + (self.spectral_bins(feat_shape[ax]),) \
            + feat_shape[ax + 1:]

    def _fusable(self, feat_shape: Tuple[int, ...]) -> bool:
        # the kernels take the [B, S, D] token-major layout
        return len(feat_shape) == 2 and self.token_axis == 1

    def _basis(self, s: int, device) -> torch.Tensor:
        return frequency.low_band_basis(s, self.rho, self.method,
                                        device=device)

    def _split(self, crf: torch.Tensor):
        """CRF -> (low_spec, high) through the op layer."""
        if self._fusable(tuple(crf.shape[1:])):
            return ops.band_split_spectral(crf, self.rho, self.method)
        x = torch.movedim(crf, self.token_axis, -2).to(_F32)
        basis = self._basis(x.shape[-2], crf.device)
        low_spec = torch.einsum("ms,...sd->...md", basis, x)
        high = x - torch.einsum("ms,...md->...sd", basis, low_spec)
        return (torch.movedim(low_spec, -2, self.token_axis).to(crf.dtype),
                torch.movedim(high, -2, self.token_axis).to(crf.dtype))

    def _synthesize(self, low_spec: torch.Tensor, s: int) -> torch.Tensor:
        """Spectral low ring entry -> spatial low band (Bᵀ·coeffs)."""
        basis = self._basis(s, low_spec.device)
        x = torch.movedim(low_spec, self.token_axis, -2).to(_F32)
        low = torch.einsum("ms,...md->...sd", basis, x)
        return torch.movedim(low, -2, self.token_axis).to(low_spec.dtype)

    # --- protocol ---------------------------------------------------------
    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=_F32, device=None, **_):
        feat_shape = tuple(feat_shape)
        return FreqCaState(
            low=base.ring_init(batch, self.k_low,
                               self.low_feat_shape(feat_shape), crf_dtype,
                               device),
            high=base.ring_init(batch, self.k_high, feat_shape, crf_dtype,
                                device),
            n_valid=torch.zeros((batch,), dtype=torch.int32, device=device))

    def update(self, state, crf, ctx):
        low_spec, high = self._split(crf)
        return state._replace(
            low=base.ring_push(state.low, low_spec, ctx.t_now),
            high=base.ring_push(state.high, high, ctx.t_now),
            n_valid=state.n_valid + 1)

    def _low_coeffs(self, state, ctx):
        return (base.ring_last(state.low) if self.low_order == 0 else
                base.ring_predict(state.low, ctx.t_now, self.low_order))

    def predict(self, state, ctx):
        s = ctx.feat_shape[self.token_axis - 1]
        low_spec = self._low_coeffs(state, ctx)
        if self.high_order > 0 and self._fusable(ctx.feat_shape):
            # one fused pass over the high ring in slot order (the K
            # folded weights are permuted instead of the K tensors)
            synth = self._basis(s, low_spec.device).T
            w = base.ring_slot_weights(state.high, ctx.t_now,
                                       self.high_order)
            return ops.freqca_predict_spectral(low_spec, synth,
                                               state.high.vals, w)
        low = self._synthesize(low_spec, s)
        high = (base.ring_last(state.high) if self.high_order == 0 else
                base.ring_predict(state.high, ctx.t_now, self.high_order))
        return low + high


@registry.register("freqca")
def _from_spec(spec) -> FreqCaPolicy:
    return FreqCaPolicy(interval=spec.interval, method=spec.method,
                        rho=spec.rho, low_order=spec.low_order,
                        high_order=spec.high_order,
                        token_axis=spec.token_axis)
