"""Legacy feature-cache API (counterpart of ``repro.core.cache``): the
``CachePolicy`` spec and the function-style state machines.

The sampler drives the policy objects of ``repro_torch.core.policies``;
``CachePolicy`` stays the string-kind spec whose ``resolve()`` returns
the registered object for its ``kind``.  The functions below
(``init_state`` / ``should_activate`` / ``update`` / ``predict``) are
what the paper's frequency analysis, the Fig-4 and Table-5 ablations and
the golden-equivalence tests use.

Kinds: ``freqca`` (low band reused or forecast at order ``low_order``,
high band Hermite-forecast at order ``high_order``, split by ``method``
at fraction ``rho``), ``freqca_a`` (the same cache), ``taylorseer`` and
``foca`` (whole-feature forecast; this API has no calibration gain),
``fora`` and ``teacache`` (whole-feature reuse) and ``none``.

The state is functional, as in the reference: ``update`` returns new
tensors and leaves the old state intact.  ``update`` splits a
``[B, S, D]`` CUDA CRF with the band-split kernel (through
``frequency.decompose``); ``predict`` is ``hermite.predict``, and the
fused form of the ``freqca`` cached step is ``ops.freqca_predict``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import frequency, hermite

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    kind: str = "freqca"          # see the module docstring
    interval: int = 5             # N: full forward every N steps
    method: str = "dct"           # fft | dct | none (frequency transform)
    rho: float = 0.0625           # low-frequency fraction of the spectrum
    low_order: int = 0            # 0 = direct reuse (paper default)
    high_order: int = 2           # Hermite order for the high band
    token_axis: int = 1           # axis of [B, S, D] to transform over
    tea_threshold: float = 0.15   # teacache / freqca_a error budget

    @property
    def k_low(self) -> int:
        return self.low_order + 1

    @property
    def k_high(self) -> int:
        return self.high_order + 1

    @property
    def cache_units(self) -> int:
        """Number of feature-sized tensors held (paper §4.4.1)."""
        if self.kind == "none":
            return 0
        if self.kind in ("fora", "teacache"):
            return 1
        if self.kind in ("taylorseer", "foca"):
            return self.k_high
        return self.k_low + self.k_high   # freqca / freqca_a

    def resolve(self):
        """The registered policy object for this spec.

        .. deprecated:: construct the policy object directly
           (``FreqCaPolicy(interval=5)``); the string-kind route warns
           once per process.
        """
        global _RESOLVE_WARNED
        if not _RESOLVE_WARNED:
            _RESOLVE_WARNED = True
            warnings.warn(
                "CachePolicy.resolve() is deprecated; construct policy "
                "objects from repro_torch.core.policies directly "
                "(e.g. FreqCaPolicy(interval=5))",
                DeprecationWarning, stacklevel=2)
        from repro_torch.core.policies import registry  # lazy: cycle
        return registry.resolve(self)


_RESOLVE_WARNED = False


class CacheState(NamedTuple):
    low_hist: torch.Tensor     # [K_low,  *feat] spatial-domain low band
    high_hist: torch.Tensor    # [K_high, *feat] spatial-domain high band
    ts_low: torch.Tensor       # [K_low] float32
    ts_high: torch.Tensor      # [K_high] float32
    n_valid: torch.Tensor      # [] int32 — activated steps seen so far


def init_state(policy: CachePolicy, feat_shape: Tuple[int, ...],
               dtype=_F32, device=None) -> CacheState:
    kl, kh = policy.k_low, policy.k_high
    if policy.kind in ("fora", "teacache"):
        kl, kh = 1, 1
    if policy.kind in ("taylorseer", "foca", "none"):
        kl = 1  # unused slot kept tiny-but-static
    feat_shape = tuple(feat_shape)
    return CacheState(
        low_hist=torch.zeros((kl,) + feat_shape, dtype=dtype, device=device),
        high_hist=torch.zeros((kh,) + feat_shape, dtype=dtype,
                              device=device),
        ts_low=torch.full((kl,), -1.0, dtype=_F32, device=device),
        ts_high=torch.full((kh,), -1.0, dtype=_F32, device=device),
        n_valid=torch.zeros((), dtype=torch.int32, device=device))


def _needed_history(policy: CachePolicy) -> int:
    if policy.kind in ("fora", "teacache"):
        return 1
    if policy.kind in ("taylorseer", "foca"):
        return policy.k_high
    if policy.kind in ("freqca", "freqca_a"):
        return max(policy.k_low, policy.k_high)
    return 1


def should_activate(policy: CachePolicy, state: CacheState,
                    step_idx) -> torch.Tensor:
    """The paper's schedule: a full forward every ``interval`` steps,
    plus full steps until the history is populated -> [] bool."""
    if policy.kind == "none":
        return torch.ones((), dtype=torch.bool, device=state.n_valid.device)
    scheduled = (step_idx % policy.interval) == 0
    warmup = state.n_valid < _needed_history(policy)
    return warmup | scheduled


def _push(hist, ts, value, t):
    """Roll the history one slot towards the front, then set the last
    slot (new tensors; the inputs are untouched)."""
    hist = torch.roll(hist, -1, dims=0)
    hist[-1] = value.to(hist.dtype)
    ts = torch.roll(ts, -1, dims=0)
    ts[-1] = torch.as_tensor(t, dtype=_F32)
    return hist, ts


def update(policy: CachePolicy, state: CacheState, z: torch.Tensor,
           t) -> CacheState:
    """Push the freshly computed CRF ``z`` (activated step at time t)."""
    if policy.kind == "none":
        return state
    if policy.kind in ("fora", "taylorseer", "foca", "teacache"):
        low, high = torch.zeros_like(z), z
    else:  # freqca / freqca_a
        low, high = frequency.decompose(z, policy.rho, policy.method,
                                        axis=policy.token_axis)
    low_hist, ts_low = _push(state.low_hist, state.ts_low, low, t)
    high_hist, ts_high = _push(state.high_hist, state.ts_high, high, t)
    return CacheState(low_hist=low_hist, high_hist=high_hist,
                      ts_low=ts_low, ts_high=ts_high,
                      n_valid=state.n_valid + 1)


def predict(policy: CachePolicy, state: CacheState, t) -> torch.Tensor:
    """Reconstruct ẑ_t from the cache (cached step at time t)."""
    if policy.kind in ("fora", "teacache"):
        return state.high_hist[-1]
    if policy.kind in ("taylorseer", "foca"):
        # no per-lane gain state here: foca degrades to the
        # uncalibrated forecast (the policy object is the real thing)
        return hermite.predict(state.ts_high, state.high_hist, t,
                               policy.high_order)
    if policy.kind not in ("freqca", "freqca_a"):
        raise ValueError(f"policy kind {policy.kind!r} has no prediction")
    if policy.low_order == 0:
        low = state.low_hist[-1]
    else:
        low = hermite.predict(state.ts_low, state.low_hist, t,
                              policy.low_order)
    if policy.high_order == 0:
        high = state.high_hist[-1]
    else:
        high = hermite.predict(state.ts_high, state.high_hist, t,
                               policy.high_order)
    return low + high


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def cache_bytes(state: CacheState, policy: CachePolicy = None) -> int:
    """Bytes the policy actually caches.

    ``init_state`` keeps a tiny-but-static dummy ``low_hist`` slot for
    the kinds that never decompose, so the raw state size over-reports
    them.  With ``policy`` the dummy slots are left out (Table-5 memory
    accounting); without it the raw size is returned (allocation
    footprint).
    """
    total = sum(_nbytes(t) for t in state)
    if policy is None:
        return total
    if policy.kind == "none":
        return 0
    if policy.kind in ("fora", "taylorseer", "foca", "teacache"):
        return total - (_nbytes(state.low_hist) + _nbytes(state.ts_low))
    return total


# ---------------------------------------------------------------------------
# layer-wise variant (paper Fig. 4 / Table 5 ablation)
# ---------------------------------------------------------------------------

class LayerwiseState(NamedTuple):
    """Caches every layer's residual delta — the O(L) baseline."""
    hist: torch.Tensor         # [K, L, *feat]
    ts: torch.Tensor           # [K]
    n_valid: torch.Tensor      # [] int32


def layerwise_init(policy: CachePolicy, n_layers: int,
                   feat_shape: Tuple[int, ...], dtype=_F32,
                   device=None) -> LayerwiseState:
    k = policy.k_high
    return LayerwiseState(
        hist=torch.zeros((k, n_layers) + tuple(feat_shape), dtype=dtype,
                         device=device),
        ts=torch.full((k,), -1.0, dtype=_F32, device=device),
        n_valid=torch.zeros((), dtype=torch.int32, device=device))


def layerwise_update(policy: CachePolicy, state: LayerwiseState,
                     residuals: torch.Tensor, t) -> LayerwiseState:
    hist, ts = _push(state.hist, state.ts, residuals, t)
    return LayerwiseState(hist=hist, ts=ts, n_valid=state.n_valid + 1)


def layerwise_predict(policy: CachePolicy, state: LayerwiseState, t,
                      h0: torch.Tensor) -> torch.Tensor:
    """Predict each layer residual, reconstruct CRF = h0 + Σ_l F̂^l."""
    res = hermite.predict(state.ts, state.hist, t, policy.high_order)
    return h0 + res.sum(dim=0)
