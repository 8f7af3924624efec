"""Policy resolution and per-lane policy banks (counterpart of
``repro.core.policies.registry``).

``bank(policy, batch)`` turns a policy — or a per-lane sequence of
policies — into the :class:`PolicyBank` the sampler drives.  A bank
exposes the policy protocol batched over lanes plus three flags:

* ``scalar_decision`` — the mask is batch-uniform by construction, so
  the sampler branches on one lane's decision;
* ``always_full`` — every lane is the ``none`` policy; no branch at all;
* ``uses_error_feedback`` — some lane consumes realized-error
  observations (``freqca_eb``), so the sampler measures and feeds back.

A batch whose lanes run different policies is a :class:`MixedBank`: one
lane-1 state per lane, so lanes with different state structures share
one batch.

``register(name)`` decorates a ``spec -> Policy`` factory; ``resolve``
takes a policy object (passed through) or a spec with a ``.kind`` (the
legacy ``repro_torch.core.cache.CachePolicy``).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import torch

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
                                           freqca_a, freqca_eb, none,
                                           taylorseer, teacache)


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
    # any lane consumes realized-error observations: the sampler adds the
    # measure / observe hooks only then
    uses_error_feedback: bool = False
    batch: int

    def compatibility_key(self):
        raise NotImplementedError

    def init(self, feat_shape, crf_dtype, latent_shape, latent_dtype,
             device=None):
        raise NotImplementedError

    def decide(self, state, ctx: base.StepContext):
        raise NotImplementedError

    def apply_update(self, state, crf, ctx: base.StepContext, mask):
        """Push ``crf`` and merge the result into the masked lanes."""
        raise NotImplementedError

    def predict(self, state, ctx: base.StepContext):
        raise NotImplementedError

    # --- error feedback ---------------------------------------------------
    def measure_error(self, state, crf, ctx: base.StepContext):
        """Per-lane realized-error measurement (pre-update state)."""
        raise NotImplementedError

    def observe(self, state, err, ctx: base.StepContext, mask):
        """Feed measurements back, merged into the masked lanes only (a
        lane alone would not have measured on a step it skipped)."""
        raise NotImplementedError

    def error_feedback(self, state):
        """[B]-shaped :class:`~repro_torch.core.policies.base.ErrorFeedback`
        of the final state, or ``None``."""
        return None


class UniformBank(PolicyBank):
    """Every lane runs the same policy; state is batched in one tree."""

    def __init__(self, policy: base.Policy, batch: int):
        self.policy = policy
        self.batch = batch
        self.scalar_decision = not policy.per_lane
        self.always_full = policy.name == "none"
        self.uses_error_feedback = policy.uses_error_feedback

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

    def measure_error(self, state, crf, ctx):
        return self.policy.measure_error(state, crf, ctx)

    def observe(self, state, err, ctx, mask):
        new = self.policy.observe(state, err, ctx)
        return base.lane_select(mask, new, state)

    def error_feedback(self, state):
        return self.policy.error_feedback(state)


class MixedBank(PolicyBank):
    """One policy per lane; the state is a tuple of lane-1 states, so
    lanes with different policies (and state structures) share a batch.
    Every hook runs each lane's policy on its own lane, in lane order."""

    def __init__(self, policies: Sequence[base.Policy]):
        self.policies = tuple(policies)
        self.batch = len(self.policies)
        self.scalar_decision = False
        self.always_full = all(p.name == "none" for p in self.policies)
        self.uses_error_feedback = any(p.uses_error_feedback
                                       for p in self.policies)

    def compatibility_key(self):
        keys = tuple(p.compatibility_key() for p in self.policies)
        return keys[0] if all(k == keys[0] for k in keys) else keys

    def init(self, feat_shape, crf_dtype, latent_shape, latent_dtype,
             device=None):
        return tuple(p.init(1, feat_shape, crf_dtype,
                            latent_shape=latent_shape,
                            latent_dtype=latent_dtype, device=device)
                     for p in self.policies)

    def decide(self, state, ctx):
        states, masks = [], []
        for j, pol in enumerate(self.policies):
            st, m = pol.decide(state[j], ctx.lane(j))
            states.append(st)
            masks.append(m)
        return tuple(states), torch.cat(masks)

    def apply_update(self, state, crf, ctx, mask):
        # every lane is pushed (the mask stays on the device) and merged
        # under its own mask bit; the clone keeps the in-place ring push
        # off the state a lane that did not activate goes on with
        out = []
        for j, pol in enumerate(self.policies):
            new = pol.update(base.tree_clone(state[j]), crf[j:j + 1],
                             ctx.lane(j))
            out.append(base.lane_select(mask[j:j + 1], new, state[j]))
        return tuple(out)

    def predict(self, state, ctx):
        return torch.cat([pol.predict(state[j], ctx.lane(j))
                          for j, pol in enumerate(self.policies)])

    def measure_error(self, state, crf, ctx):
        # per-lane tuple: error shapes may differ across policies;
        # None for lanes that consume no feedback
        return tuple(
            pol.measure_error(state[j], crf[j:j + 1], ctx.lane(j))
            if pol.uses_error_feedback else None
            for j, pol in enumerate(self.policies))

    def observe(self, state, err, ctx, mask):
        out = []
        for j, pol in enumerate(self.policies):
            if pol.uses_error_feedback:
                new = pol.observe(state[j], err[j], ctx.lane(j))
                out.append(base.lane_select(mask[j:j + 1], new, state[j]))
            else:
                out.append(state[j])
        return tuple(out)

    def error_feedback(self, state):
        if not self.uses_error_feedback:
            return None
        parts = []
        for j, pol in enumerate(self.policies):
            fb = pol.error_feedback(state[j])
            if fb is None:
                dev = base.tree_leaves(state[j])[0].device
                fb = base.ErrorFeedback(
                    realized=torch.zeros((1,), dtype=torch.float32,
                                         device=dev),
                    events=torch.zeros((1,), dtype=torch.int32, device=dev))
            parts.append(fb)
        return base.ErrorFeedback(
            realized=torch.cat([p.realized for p in parts]),
            events=torch.cat([p.events for p in parts]))


def bank(policy: Union[base.Policy, Sequence[base.Policy]],
         batch: int) -> PolicyBank:
    """Policy / spec / per-lane sequence thereof -> PolicyBank: a
    sequence of equal policies collapses to a :class:`UniformBank`, any
    other to a :class:`MixedBank`."""
    if isinstance(policy, (list, tuple)):
        lanes = tuple(resolve(p) for p in policy)
        if len(lanes) != batch:
            raise ValueError(f"got {len(lanes)} lane policies for "
                             f"batch {batch}")
        if all(p == lanes[0] for p in lanes):
            return UniformBank(lanes[0], batch)
        return MixedBank(lanes)
    return UniformBank(resolve(policy), batch)
