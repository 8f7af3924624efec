"""Policy resolution and per-lane policy banks (counterpart of
``repro.core.policies.registry``).

``bank(policy, batch)`` turns a policy — or a per-lane sequence of
equal policies — into the :class:`PolicyBank` the sampler drives.  A
bank exposes the policy protocol batched over lanes plus two flags:

* ``scalar_decision`` — the mask is batch-uniform by construction, so
  the sampler branches on one lane's decision;
* ``always_full`` — the ``none`` policy; no branch at all.

``register(name)`` decorates a ``spec -> Policy`` factory; ``resolve``
takes a policy object (passed through) or a spec with a ``.kind`` (the
legacy ``repro_torch.core.cache.CachePolicy``).  ``freqca_eb`` is not
registered yet: it needs the sampler's error-feedback hooks.

Banks mixing different policies per lane (``MixedBank``) are not ported
yet; ``bank`` raises for them.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

from repro_torch.core.policies import base

_FACTORIES: Dict[str, Callable] = {}


def register(name: str):
    """Decorator: register a ``spec -> Policy`` factory under ``name``."""
    def deco(factory: Callable) -> Callable:
        _FACTORIES[name] = factory
        return factory
    return deco


def _ensure_builtin() -> None:
    # imported for their registrations; lazy, as they import this module
    from repro_torch.core.policies import (foca, fora, freqca,  # noqa: F401
                                           freqca_a, none, taylorseer,
                                           teacache)


def available() -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_FACTORIES))


def resolve(policy) -> base.Policy:
    """Policy object (passed through) or ``.kind`` spec -> Policy."""
    if isinstance(policy, base.Policy):
        return policy
    kind = getattr(policy, "kind", None)
    if kind is None:
        raise TypeError(
            f"expected a Policy or a spec with a .kind, got {policy!r}")
    _ensure_builtin()
    if kind not in _FACTORIES:
        raise KeyError(f"unknown cache policy {kind!r}; "
                       f"registered: {available()}")
    return _FACTORIES[kind](policy)


def compatibility_key(policy) -> Tuple:
    """Batch-compatibility key of a policy (see
    :meth:`~repro_torch.core.policies.base.Policy.compatibility_key`)."""
    return resolve(policy).compatibility_key()


class PolicyBank:
    """Per-lane policy assignment for one sampler batch (abstract)."""
    scalar_decision: bool
    always_full: bool
    batch: int


class UniformBank(PolicyBank):
    """Every lane runs the same policy; state is batched in one tree."""

    def __init__(self, policy: base.Policy, batch: int):
        self.policy = policy
        self.batch = batch
        self.scalar_decision = not policy.per_lane
        self.always_full = policy.name == "none"

    def compatibility_key(self):
        return self.policy.compatibility_key()

    def init(self, feat_shape, crf_dtype, latent_shape, latent_dtype,
             device=None):
        return self.policy.init(self.batch, feat_shape, crf_dtype,
                                latent_shape=latent_shape,
                                latent_dtype=latent_dtype, device=device)

    def decide(self, state, ctx):
        return self.policy.decide(state, ctx)

    def apply_update(self, state, crf, ctx, mask):
        """Push ``crf`` and merge the result into the masked lanes."""
        if self.scalar_decision:
            # the sampler only runs the full branch when the (uniform)
            # mask is set, so every lane activated — no select needed
            return self.policy.update(state, crf, ctx)
        # rings update in place: keep the old state for the lanes that
        # did not activate
        new = self.policy.update(base.tree_clone(state), crf, ctx)
        return base.lane_select(mask, new, state)

    def predict(self, state, ctx):
        return self.policy.predict(state, ctx)


def bank(policy: Union[base.Policy, Sequence[base.Policy]],
         batch: int) -> PolicyBank:
    """Policy / spec / per-lane sequence of equal ones -> PolicyBank."""
    if isinstance(policy, (list, tuple)):
        lanes = tuple(resolve(p) for p in policy)
        if len(lanes) != batch:
            raise ValueError(f"got {len(lanes)} lane policies for "
                             f"batch {batch}")
        if any(p != lanes[0] for p in lanes):
            raise NotImplementedError(
                "mixed-policy batches (MixedBank) are not ported yet")
        return UniformBank(lanes[0], batch)
    return UniformBank(resolve(policy), batch)
