"""Cache-policy protocol (counterpart of ``repro.core.policies.base``).

A policy owns all of its state behind four methods:

* ``init(batch, feat_shape, ...)``  -> lane-major state (NamedTuple of
  tensors)
* ``decide(state, ctx)``            -> ``(state, [B] bool mask)``
* ``update(state, crf, ctx)``       -> state with the fresh CRF pushed
* ``predict(state, ctx)``           -> ẑ_t reconstructed from the cache

Every state leaf is lane-major (``[B, ...]``).  Policies are frozen
dataclasses, hashable and compared by value, so the scheduler can group
requests by them.

One deliberate difference from the reference: ``ring_push`` writes its
slot **in place** (JAX's update is functional).  At FLUX shapes a
functional push would copy the whole ``[B, K, S, D]`` ring on every full
step; in place it writes one ``[B, S, D]`` slot.  A caller that still
needs the pre-push state must clone it first (``tree_clone``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, List, NamedTuple, Optional, Tuple

import torch

_F32 = torch.float32


# --- tiny pytree helpers over NamedTuple / tuple / tensor states ---------

def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over tensors of equally-structured trees."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    raise TypeError(f"unsupported state node {type(tree)!r}")


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_clone(tree):
    return tree_map(torch.clone, tree)


class ErrorFeedback(NamedTuple):
    """Per-lane realized-error report extracted from a policy state.

    ``realized`` is the largest accumulated prediction error a lane
    committed between two consecutive full forwards (what a request's
    ``max_error`` bounds); ``events`` counts the full forwards the budget
    triggered (warm-up fills excluded).
    """
    realized: torch.Tensor         # [B] float32 — peak inter-full error
    events: torch.Tensor           # [B] int32 — budget-triggered fulls


class StepContext(NamedTuple):
    """Per-step observation handed to the policy by the sampler.

    ``step_idx`` is a Python int and ``t_now`` a 0-d float32 tensor on
    the sampler's device; ``batch`` / ``feat_shape`` / ``crf_dtype`` are
    static Python values.
    """
    step_idx: int
    t_now: torch.Tensor
    x: torch.Tensor                # [B, *latent] — model input this step
    batch: int
    feat_shape: Tuple[int, ...]    # per-lane CRF feature shape
    crf_dtype: Any = torch.float32

    def lane(self, j: int) -> "StepContext":
        return self._replace(x=self.x[j:j + 1], batch=1)


class Ring(NamedTuple):
    """Lane-major ring of the K most recent activated features.

    Slots are cyclic: ``head[b]`` is the next slot lane ``b`` will
    overwrite, so a push touches one slot.  Readers that need recency
    order gather through ``ring_order``.
    """
    vals: torch.Tensor             # [B, K, *feat] cyclic slots
    ts: torch.Tensor               # [B, K] activation timestamps
    head: torch.Tensor             # [B] int32 — next slot to write


def ring_init(batch: int, k: int, feat_shape: Tuple[int, ...],
              dtype=_F32, device=None) -> Ring:
    return Ring(
        vals=torch.zeros((batch, k) + tuple(feat_shape), dtype=dtype,
                         device=device),
        ts=torch.full((batch, k), -1.0, dtype=_F32, device=device),
        head=torch.zeros((batch,), dtype=torch.int32, device=device))


def ring_push(ring: Ring, value: torch.Tensor, t) -> Ring:
    """Push a ``[B, *feat]`` value observed at scalar time ``t``: one
    slot per lane, written in place (see the module docstring)."""
    b, k = ring.ts.shape
    lanes = torch.arange(b, device=ring.vals.device)
    ring.vals[lanes, ring.head] = value.to(ring.vals.dtype)
    slot = torch.arange(k, device=ring.ts.device)[None, :] \
        == ring.head[:, None]
    ts = torch.where(slot, torch.as_tensor(t, dtype=_F32,
                                           device=ring.ts.device), ring.ts)
    return Ring(vals=ring.vals, ts=ts, head=(ring.head + 1) % k)


def ring_order(ring: Ring) -> torch.Tensor:
    """[B, K] slot permutation, oldest -> newest (head is the oldest)."""
    k = ring.ts.shape[1]
    return (ring.head[:, None]
            + torch.arange(k, device=ring.head.device)[None, :]) % k


def ring_ordered(ring: Ring) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ts [B, K], vals [B, K, *feat]) gathered oldest -> newest."""
    idx = ring_order(ring)
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return torch.gather(ring.ts, 1, idx), ring.vals[lanes, idx]


def ring_last(ring: Ring) -> torch.Tensor:
    """Most recent cached value per lane -> [B, *feat] (order-0 reuse)."""
    k = ring.ts.shape[1]
    lanes = torch.arange(ring.head.shape[0], device=ring.head.device)
    return ring.vals[lanes, (ring.head - 1) % k]


def ring_weights(ring: Ring, t_query, order: int) -> torch.Tensor:
    """Per-lane folded Hermite weights in recency order -> [B, K]."""
    from repro_torch.kernels import ops
    ts = torch.gather(ring.ts, 1, ring_order(ring))
    return ops.hermite_weights(ts, t_query, order)


def ring_slot_weights(ring: Ring, t_query, order: int) -> torch.Tensor:
    """Folded per-lane Hermite weights indexed by ring **slot**, so a
    fused kernel reads ``ring.vals`` in memory order: the K scalars are
    permuted instead of the K feature tensors."""
    k = ring.ts.shape[1]
    w = ring_weights(ring, t_query, order)
    inv = (torch.arange(k, device=w.device)[None, :]
           - ring.head[:, None]) % k
    return torch.gather(w, 1, inv)


def ring_predict(ring: Ring, t_query, order: int) -> torch.Tensor:
    """Per-lane Hermite forecast at ``t_query`` -> [B, *feat], over the
    ring in recency order (the plain twin of the fused kernel path)."""
    ts, vals = ring_ordered(ring)
    w = ring_weights(ring, t_query, order)
    out = torch.einsum("bk,bk...->b...", w, vals.to(_F32))
    return out.to(vals.dtype)


def lane_select(mask: torch.Tensor, new, old):
    """Per-lane merge: lane ``j`` takes ``new`` where ``mask[j]``."""
    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - 1)),
                           n, o)
    return tree_map(sel, new, old)


def lane_mean_abs(x: torch.Tensor) -> torch.Tensor:
    """mean |x| per lane over all non-batch axes -> [B] float32."""
    return x.to(_F32).abs().mean(dim=tuple(range(1, x.ndim)))


def lane_rel_norm(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-lane relative L2 error ||pred − target|| / ||target|| -> [B]."""
    axes = tuple(range(1, target.ndim))
    p, t = pred.to(_F32), target.to(_F32)
    num = (p - t).square().sum(dim=axes).sqrt()
    den = t.square().sum(dim=axes).sqrt()
    return num / torch.clamp(den, min=1e-6)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Base cache policy: scheduled activation every ``interval`` steps
    plus a warm-up of full steps until ``needed_history`` entries exist.
    The default ``decide`` reads the state's ``n_valid: [B] int32``."""
    interval: int = 5

    name: ClassVar[str] = "abstract"
    # True when decide() can return lane-varying masks (adaptive
    # policies); False lets the sampler branch on one lane's decision
    per_lane: ClassVar[bool] = False
    # True when the policy consumes realized-error observations: the
    # sampler then measures the prediction error on every full step and
    # feeds it back through ``observe``
    uses_error_feedback: ClassVar[bool] = False

    # --- protocol --------------------------------------------------------
    def init(self, batch: int, feat_shape: Tuple[int, ...],
             crf_dtype=_F32, latent_shape: Tuple[int, ...] = (),
             latent_dtype=_F32, device=None):
        """Fresh per-batch cache state for one (batch, shape) signature;
        everything is sized from ``feat_shape = (S, D)``."""
        raise NotImplementedError

    def decide(self, state, ctx: StepContext):
        """-> (state, [B] bool mask).  Runs every step."""
        scheduled = (ctx.step_idx % self.interval) == 0
        warm = state.n_valid < self.needed_history
        return state, warm | scheduled

    def update(self, state, crf: torch.Tensor, ctx: StepContext):
        raise NotImplementedError

    def predict(self, state, ctx: StepContext) -> torch.Tensor:
        raise NotImplementedError

    # --- error feedback (optional) ---------------------------------------
    def measure_error(self, state, crf: torch.Tensor,
                      ctx: StepContext) -> torch.Tensor:
        """Realized prediction error against the fresh CRF, per lane.

        Called by the sampler on full steps *before* ``update`` pushes
        the fresh feature (only when ``uses_error_feedback``), so the
        state still holds the cache the lane would have served.  The
        default scores the whole-feature relative L2 of ``predict``.
        """
        return lane_rel_norm(self.predict(state, ctx), crf)

    def observe(self, state, realized_error: torch.Tensor,
                ctx: StepContext):
        """Ingest a realized-error measurement (no-op by default).  Runs
        on full steps after ``update``; the bank merges the result back
        into the activated lanes only."""
        return state

    def error_feedback(self, state) -> Optional[ErrorFeedback]:
        """The realized-error report of a final state, or ``None`` for
        policies that track no feedback."""
        return None

    def with_budget(self, max_error: Optional[float]) -> "Policy":
        """Specialize to a per-request error budget.  ``None`` (no SLO)
        and policies without error feedback return ``self`` unchanged,
        so request grouping stays as it was."""
        return self

    # --- metadata --------------------------------------------------------
    def compatibility_key(self) -> Tuple:
        """Batch-compatibility signature for the scheduler: static
        schedules key by the activation schedule they produce, adaptive
        policies by their full value (as in the reference)."""
        if self.per_lane:
            return ("adaptive", self)
        return ("sched", self.interval, self.needed_history)

    @property
    def needed_history(self) -> int:
        return 1

    @property
    def cache_units(self) -> int:
        return 1

    def state_bytes(self, state) -> int:
        """Actual cache footprint of a state (meta tensors work too)."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(state))
