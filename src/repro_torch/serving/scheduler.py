"""Request queue + bucketed batch formation for the diffusion engine.

A copy of ``repro.serving.scheduler`` (the scheduler is framework-free)
with the port's policy registry; its condition variable comes from the
port's copy of the reference's sanitizer factory
(``repro_torch.analysis.runtime.make_condition``).

The seed engine padded every batch to ``max_batch`` — a single request
paid full-batch latency.  The scheduler instead quantises batch sizes to
a small ladder of *bucket signatures* (powers of two up to
``max_batch``), so the engine compiles one sampler executable per bucket
and a lone request runs in the batch-1 program.

Batch formation is deadline/age-based: a batch is cut when the queue
can fill the largest bucket, when the oldest request has waited
``max_wait_s``, or when a per-request deadline is about to lapse.
Deadline-lapsed requests are *promoted* into the cut batch wherever
they sit in the queue (otherwise the batch is the stable FIFO prefix),
so a lapsed request can never be starved behind ``max_batch`` younger
ones.  ``flush=True`` cuts whatever is queued immediately (drain mode —
the seed engine's behaviour).

With ``group_policies=True`` the former partitions the queue into
**compatibility groups** (``Policy.compatibility_key()``: identical
resolved policies, or static-schedule families whose activation masks
coincide — e.g. ``fora(interval=1)`` / ``none``) and every cut batch is
policy-homogeneous.  This caps the compiled-signature count at
O(groups x buckets) instead of one signature per lane-policy *mix*
(family cuts that mix distinct member values add one signature per
policy *composition* — lane order is canonicalized at cut time so
arrival interleaving never mints a new one), and static-schedule lanes
stop paying for adaptive lanes' activations (the sampler runs a full
forward whenever any lane in the batch activates).
Group choice per cut: (1) a lapsed deadline wins — the most-overdue
request's group is cut with its lapsed members promoted; (2) age
pressure (and ``flush``) cuts the group of the oldest request overall,
so a rare policy is served the moment its request heads the queue and
can never be starved by a busier group; (3) a full bucket alone cuts
the full group with the earliest-submitted member.  Within the chosen
group the batch is the lapsed members plus the FIFO prefix, in stable
FIFO order — exactly the ungrouped rule applied to the group.

Multi-resolution serving folds a canonical **shape key** —
``(latent_shape, crf_shape)`` — into the cut key *unconditionally*:
mixed-shape lanes cannot share one executable, so every cut is
shape-pure in any mode, and under grouping the cut key is
(shape, compatibility group).  ``submit`` validates each request's
declared shape against the deployment's shape ladder and raises
``ShapeMismatchError`` at the API boundary instead of failing deep
inside the jitted executable.

The queue is guarded by a condition variable (``cv``): ``submit`` /
``form_batch`` / ``ready`` are safe to call from any thread, submitters
wake anyone waiting on ``cv``, and ``seconds_until_ready`` tells a
worker exactly how long it may sleep before age or deadline pressure
would cut a batch — so the async engine blocks on wakeups instead of
sleep-polling.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

from repro_torch.analysis.runtime import make_condition


class ShapeMismatchError(ValueError):
    """The request's ``(latent_shape, crf_shape)`` (or its
    ``init_latents``) does not match the deployment's declared shape
    ladder.  Raised at the API boundary (``Scheduler.submit`` /
    ``FleetRouter.submit``) instead of failing deep inside the jitted
    executable — or worse, silently minting a new compiled signature."""


# canonical shape key: ((H, W, C) latent shape, (S, D) per-sample CRF
# shape) — the shape half of a (batch-bucket, shape-bucket) signature
ShapeKey = Tuple[Tuple[int, ...], Tuple[int, ...]]


def resolve_shape_key(latent_shape, crf_shape,
                      default_shape: Optional[ShapeKey],
                      allowed_shapes=None) -> Optional[ShapeKey]:
    """Canonicalize a request's (possibly partial) shape declaration.

    Both fields ``None`` -> the deployment default.  One field given ->
    completed from the unique ladder entry matching it (so a client may
    declare just the latent size), falling back to the default's other
    half.  Returns ``None`` only when no default is known (a bare
    scheduler outside any engine).
    """
    if latent_shape is None and crf_shape is None:
        return default_shape
    lat = tuple(latent_shape) if latent_shape is not None else None
    crf = tuple(crf_shape) if crf_shape is not None else None
    if (lat is None or crf is None) and allowed_shapes:
        matches = [s for s in allowed_shapes
                   if (lat is None or s[0] == lat)
                   and (crf is None or s[1] == crf)]
        if len(matches) == 1:
            return matches[0]
    if lat is None or crf is None:
        d = default_shape if default_shape is not None else (None, None)
        lat = lat if lat is not None else d[0]
        crf = crf if crf is not None else d[1]
    return (lat, crf)


def validate_request_shape(req, default_shape: Optional[ShapeKey],
                           allowed_shapes=None) -> Optional[ShapeKey]:
    """Resolve ``req``'s shape key and fail fast on a mismatch.

    Raises :class:`ShapeMismatchError` when the resolved key is outside
    the declared ladder, or when ``init_latents`` disagrees with the
    resolved latent shape (previously an opaque trace/broadcast error
    deep inside the donated-buffer executable).  Returns the resolved
    key (``None`` when nothing is declared — no validation possible).
    """
    shape = resolve_shape_key(req.latent_shape, req.crf_shape,
                              default_shape, allowed_shapes)
    if shape is None or shape[0] is None or shape[1] is None:
        return shape
    if allowed_shapes is not None and shape not in allowed_shapes:
        ladder = sorted(allowed_shapes)
        raise ShapeMismatchError(
            f"request {req.request_id}: shape {shape} is not in the "
            f"declared shape ladder {ladder}; declare it at engine "
            "construction (shapes=[...]) or warmup(shapes=[...])")
    if req.init_latents is not None:
        ref_shape = getattr(req.init_latents, "shape", None)
        if ref_shape is not None and tuple(ref_shape) != shape[0]:
            raise ShapeMismatchError(
                f"request {req.request_id}: init_latents shape "
                f"{tuple(ref_shape)} != declared latent shape {shape[0]}")
    return shape


@dataclasses.dataclass
class DiffusionRequest:
    """The single submission type for every serving path.

    Sync (``DiffusionEngine.submit`` / ``run_batch(reqs=...)``) and
    async (``AsyncDiffusionEngine.submit``) consume this object with
    identical field semantics; open-loop drivers carry the planned
    arrival offset in ``arrival_s`` instead of side-channel tuples.
    """
    request_id: int
    seed: int
    # optional conditioning (e.g. reference latents for editing)
    init_latents: Optional[object] = None
    edit_strength: float = 0.0
    # per-request cache policy (CachePolicy spec or Policy object);
    # None -> the engine's default.  Requests with different policies
    # share a batch lane-by-lane (per-lane activation masks).
    policy: Optional[object] = None
    # serving QoS: cut a batch early rather than let this lapse
    deadline_s: Optional[float] = None
    # quality SLO: max prediction error the cache may accumulate
    # between full forwards (snapped down to a budget tier by
    # ``Policy.with_budget``).  None -> the policy's own default
    # behaviour, bit-identical to serving without the SLO field.
    max_error: Optional[float] = None
    # multi-resolution serving: this request's latent [H, W, C] and
    # per-sample CRF [S, D] shapes.  None -> the engine's defaults.
    # Validated against the declared shape ladder at submit time
    # (ShapeMismatchError on mismatch); batches are always cut
    # shape-pure, so the (batch-bucket, shape) signature is warmed.
    latent_shape: Optional[Tuple[int, ...]] = None
    crf_shape: Optional[Tuple[int, ...]] = None
    # open-loop stream plans: seconds after stream start at which this
    # request should be submitted (0.0 for closed-loop clients)
    arrival_s: float = 0.0
    # accounting (stamped by Scheduler.submit)
    submit_time: float = 0.0
    # the budget actually served: == max_error normally, relaxed to a
    # looser tier by load shedding when the queue is deep (stamped by
    # Scheduler.submit; requests are never dropped)
    effective_max_error: Optional[float] = None


class BatchPlan(NamedTuple):
    requests: List[DiffusionRequest]
    bucket: int          # padded batch signature the engine will run
    formed_at: float     # scheduler clock when the batch was cut
    group_key: object = None   # compatibility group this cut came from
    # budget-effective per-real-lane policies (stamped by form_batch:
    # the request policy specialized to its effective_max_error tier);
    # None entries fall back to the engine default in lane_policies
    policies: Optional[List[object]] = None
    # shape half of the (batch-bucket, shape-bucket) signature: every
    # cut is shape-pure, so one pair covers the whole batch.  None ->
    # the engine's default shapes (single-shape deployments).
    latent_shape: Optional[Tuple[int, ...]] = None
    crf_shape: Optional[Tuple[int, ...]] = None

    @property
    def signature(self) -> tuple:
        """(batch-bucket, shape-bucket) — the compiled-executable key
        this plan will run under (shape ``None`` = engine default)."""
        shape = (None if self.latent_shape is None and self.crf_shape is
                 None else (self.latent_shape, self.crf_shape))
        return (self.bucket, shape)

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def occupancy(self) -> float:
        return self.n_real / max(self.bucket, 1)

    def lane_policies(self, default) -> List[object]:
        """Per-lane policy assignment; padded lanes reuse the first real
        lane's policy, so a uniform batch keeps one signature per bucket
        (the warmed ladder) and scheduled pads activate only on steps the
        real lanes already paid for — never forcing extra forwards of
        their own."""
        if self.policies is not None:
            lanes = [p if p is not None else default
                     for p in self.policies]
        else:
            lanes = [r.policy if r.policy is not None else default
                     for r in self.requests]
        pad = lanes[0] if lanes else default
        lanes += [pad] * (self.bucket - self.n_real)
        return lanes


def bucket_sizes(max_batch: int) -> List[int]:
    """Powers of two up to ``max_batch`` (always including max_batch)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest ladder signature that fits ``n`` requests.

    The ladder is ``bucket_sizes(max_batch)``: every power of two below
    ``max_batch`` plus ``max_batch`` itself.  With a non-power-of-two
    ``max_batch`` a cut sized between the largest power of two and
    ``max_batch`` therefore pads straight to ``max_batch`` (e.g. n=5,
    max_batch=6 -> 6; n=5, max_batch=7 -> 7) — intermediate sizes are
    deliberately NOT signatures, so the executable count stays
    O(log max_batch).  The ladder always ends at ``max_batch >= n``
    (checked above), so the scan below always yields.
    """
    if n < 1:
        raise ValueError(f"need at least one request, got {n}")
    if n > max_batch:
        raise ValueError(f"{n} requests exceed max_batch={max_batch}")
    return next(b for b in bucket_sizes(max_batch) if b >= n)


def bucket_signature(n: int, max_batch: int,
                     shape: Optional[ShapeKey] = None) -> tuple:
    """The (batch-bucket, shape-bucket) signature for ``n`` requests of
    one shape — the key the engine's compiled-executable cache is
    bounded by (``shapes x groups x buckets``).  ``shape=None`` is the
    single-shape deployment (engine default)."""
    return (bucket_for(n, max_batch), shape)


class Scheduler:
    """FIFO request queue with age/deadline-triggered batch cutting.

    Thread-safe: all queue access happens under ``cv`` (a reentrant
    condition variable), and every ``submit`` notifies waiters.

    ``group_policies=True`` turns on policy-homogeneous batch formation
    (see the module docstring); ``default_policy`` is what a request
    with ``policy=None`` resolves to for grouping.
    """

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.05,
                 pad_to_max: bool = False, clock=time.monotonic,
                 group_policies: bool = False, default_policy=None,
                 shed_depth: Optional[int] = None,
                 shed_factor: float = 4.0,
                 default_shape: Optional[ShapeKey] = None,
                 allowed_shapes: Optional[set] = None):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pad_to_max = pad_to_max  # seed-compatible fixed signature
        self.clock = clock
        self.group_policies = group_policies
        self.default_policy = default_policy
        # multi-resolution serving: the engine's default
        # (latent_shape, crf_shape) pair and the declared shape ladder
        # submits are validated against.  ``allowed_shapes`` is held by
        # reference (the engine shares its own set), so shapes declared
        # after construction — warmup(shapes=[...]) — are honoured.
        # None/None = a bare scheduler: shape validation is skipped and
        # every request files under one pseudo-shape.
        self.default_shape = default_shape
        self.allowed_shapes = (allowed_shapes if allowed_shapes is not None
                               else ({default_shape} if default_shape
                                     is not None else None))
        # load shedding: when the queue holds >= shed_depth requests at
        # submit time, the incoming request's effective error budget is
        # relaxed by shed_factor (snapped to a looser tier) — quality is
        # shed, never the request itself
        self.shed_depth = shed_depth
        self.shed_factor = shed_factor
        self.shed_events = 0
        self.queue: List[DiffusionRequest] = []
        self.submitted = 0
        # sanitizer-aware: a plain Condition(RLock()) unless
        # REPRO_SANITIZE=1, then lock-order-instrumented
        self.cv = make_condition("Scheduler.cv")
        self._key_cache: dict = {}   # policy/spec -> compatibility key
        self._pol_cache: dict = {}   # (policy, budget) -> effective Policy

    def __len__(self) -> int:
        with self.cv:
            return len(self.queue)

    @property
    def depth(self) -> int:
        return len(self)

    def validate(self, req: DiffusionRequest) -> Optional[ShapeKey]:
        """Resolve + validate the request's shape against the declared
        ladder (see :func:`validate_request_shape`); raises
        :class:`ShapeMismatchError` without touching the queue."""
        return validate_request_shape(req, self.default_shape,
                                      self.allowed_shapes)

    def shape_of(self, req: DiffusionRequest) -> Optional[ShapeKey]:
        """Canonical shape key this request files under (no validation
        — submit already did that)."""
        return resolve_shape_key(req.latent_shape, req.crf_shape,
                                 self.default_shape, self.allowed_shapes)

    def submit(self, req: DiffusionRequest,
               now: Optional[float] = None) -> None:
        with self.cv:
            # fail fast BEFORE any queue/counter mutation: a rejected
            # request leaves no trace (submitted stays in step with the
            # serve path)
            self.validate(req)
            req.submit_time = self.clock() if now is None else now
            req.effective_max_error = req.max_error
            if (req.max_error is not None and self.shed_depth is not None
                    and len(self.queue) >= self.shed_depth):
                req.effective_max_error = req.max_error * self.shed_factor
                self.shed_events += 1
            self.queue.append(req)
            self.submitted += 1
            self.cv.notify_all()

    def _lapsed(self, now: float) -> List[int]:
        """Queue indices whose deadline has already passed."""
        return [i for i, r in enumerate(self.queue)
                if r.deadline_s is not None
                and now - r.submit_time >= r.deadline_s]

    def _deadline_pressure(self, now: float) -> bool:
        return bool(self._lapsed(now))

    def effective_policy(self, req: DiffusionRequest):
        """The policy this request will actually be served with: its own
        (or the default), specialized to the effective error budget —
        ``Policy.with_budget`` snaps the budget to a tier, so the number
        of distinct effective policies stays bounded."""
        pol = req.policy if req.policy is not None else self.default_policy
        budget = req.effective_max_error
        if pol is None or budget is None:
            return pol
        ck = (pol, budget)
        got = self._pol_cache.get(ck)
        if got is None:
            from repro_torch.core.policies import registry
            got = self._pol_cache[ck] = (
                registry.resolve(pol).with_budget(budget))
        return got

    def group_key(self, req: DiffusionRequest):
        """Compatibility-group key of a request's (resolved) policy,
        budget tier included — ``with_budget`` returns a distinct policy
        value per tier and adaptive policies key on their full value, so
        requests group by (policy, budget tier) automatically."""
        pol = self.effective_policy(req)
        if pol is None:
            return None
        key = self._key_cache.get(pol)
        if key is None:
            from repro_torch.core.policies import registry
            key = self._key_cache[pol] = registry.compatibility_key(pol)
        return key

    def _cut_key(self, req: DiffusionRequest) -> tuple:
        """(shape key, compatibility key) a cut must be pure in.

        The shape half ALWAYS folds in — mixed-shape lanes cannot share
        one executable (``jnp.stack`` would fail outright), so shape
        purity is a physical requirement of every former, grouped or
        not.  The policy half folds in only under ``group_policies``
        (the PR-5 ``compatibility_key()`` path).  A single-shape
        ungrouped deployment collapses to one constant key — the
        original whole-queue FIFO former, bit-identical.
        """
        return (self.shape_of(req),
                self.group_key(req) if self.group_policies else None)

    def groups(self) -> dict:
        """Queued request count per (shape, compatibility-group) cut key
        (one pseudo-group of the whole queue for a bare single-shape
        ungrouped scheduler)."""
        with self.cv:
            counts: dict = {}
            for r in self.queue:
                k = self._cut_key(r)
                counts[k] = counts.get(k, 0) + 1
            return counts

    def _full_group(self) -> bool:
        """Can some (shape- and group-pure) cut fill the largest bucket
        right now?"""
        return any(n >= self.max_batch for n in self.groups().values())

    def ready(self, now: Optional[float] = None) -> bool:
        """Would ``form_batch`` cut a batch right now (without flushing)?

        Under ``group_policies`` the full-queue trigger becomes a
        full-*group* trigger: ten requests spread over three groups fill
        no policy-pure bucket, so only age/deadline pressure cuts.
        """
        with self.cv:
            if not self.queue:
                return False
            now = self.clock() if now is None else now
            if self._full_group():
                return True
            oldest_age = now - self.queue[0].submit_time
            return (oldest_age >= self.max_wait_s
                    or self._deadline_pressure(now))

    def seconds_until_ready(self, now: Optional[float] = None
                            ) -> Optional[float]:
        """How long until age/deadline pressure would cut a batch.

        Returns ``None`` for an empty queue (nothing to wait for — a
        submit will notify ``cv``), ``0.0`` if a batch is ready now, else
        the soonest of (oldest request hitting ``max_wait_s``, earliest
        deadline lapsing).  A worker can ``cv.wait(...)`` exactly this
        long instead of sleep-polling.
        """
        with self.cv:
            if not self.queue:
                return None
            now = self.clock() if now is None else now
            if self.ready(now):
                return 0.0
            until = self.max_wait_s - (now - self.queue[0].submit_time)
            for r in self.queue:
                if r.deadline_s is not None:
                    until = min(until,
                                r.deadline_s - (now - r.submit_time))
            return max(until, 0.0)

    def _cut_group(self, now: float, flush: bool):
        """(key, member queue-indices in FIFO order) of the next cut.

        Keys are ``_cut_key`` values — (shape, compatibility group) —
        so every cut is shape-pure in any mode and policy-pure under
        grouping."""
        keys = [self._cut_key(r) for r in self.queue]
        lapsed = self._lapsed(now)
        if lapsed:
            # a lapsed deadline wins: the most-overdue request's group
            # is the next cut (its lapsed members get promoted below)
            j = max(lapsed, key=lambda i: now - self.queue[i].submit_time
                    - self.queue[i].deadline_s)
            key = keys[j]
        elif flush or now - self.queue[0].submit_time >= self.max_wait_s:
            # age pressure / drain: FIFO across groups — the oldest
            # request's group, so a rare policy is served as soon as its
            # request heads the queue and can never be starved by a
            # busier group
            key = keys[0]
        else:
            # full-bucket trigger alone: the full group with the
            # earliest-submitted member
            counts: dict = {}
            for k in keys:
                counts[k] = counts.get(k, 0) + 1
            key = next(k for k in keys if counts[k] >= self.max_batch)
        return key, [i for i, k in enumerate(keys) if k == key]

    def form_batch(self, now: Optional[float] = None,
                   flush: bool = False) -> Optional[BatchPlan]:
        """Cut the next batch, or None if nothing is ready yet.

        Deadline-lapsed requests are promoted into the cut wherever they
        sit in the queue (a lapsed request beyond position ``max_batch``
        used to trigger the cut yet be excluded from it — and could lapse
        indefinitely under sustained load); the remaining slots are the
        FIFO prefix, and the batch keeps stable FIFO order overall.

        Under ``group_policies`` the same rule is applied to the members
        of one compatibility group (chosen by ``_cut_group``), so every
        emitted batch is policy-pure and lapsed requests of *other*
        groups are served by the immediately following cuts — deadline
        priority picks their group next.
        """
        with self.cv:
            now = self.clock() if now is None else now
            if not self.queue or not (flush or self.ready(now)):
                return None
            # every cut goes through the group machinery: the key is
            # (shape, policy-group-or-None), so cuts are shape-pure in
            # ANY mode (mixed shapes can't share an executable) and a
            # single-shape ungrouped queue degenerates to one constant
            # key — the whole-queue FIFO former, unchanged
            (shape, gkey), members = self._cut_group(now, flush)
            lapsed_set = set(self._lapsed(now))
            take = min(len(members), self.max_batch)
            picked = [i for i in members if i in lapsed_set][:take]
            picked_set = set(picked)
            for i in members:
                if len(picked) >= take:
                    break
                if i not in picked_set:
                    picked.append(i)
                    picked_set.add(i)
            reqs = [self.queue[i] for i in sorted(picked)]  # stable FIFO
            if self.group_policies:
                reqs = self._canonical_lane_order(reqs)
            self.queue = [r for i, r in enumerate(self.queue)
                          if i not in picked_set]
            bucket = (self.max_batch if self.pad_to_max
                      else bucket_for(take, self.max_batch))
            return BatchPlan(requests=reqs, bucket=bucket, formed_at=now,
                             group_key=gkey,
                             policies=[self.effective_policy(r)
                                       for r in reqs],
                             latent_shape=(shape[0] if shape else None),
                             crf_shape=(shape[1] if shape else None))

    def _canonical_lane_order(self, reqs: List[DiffusionRequest]
                              ) -> List[DiffusionRequest]:
        """Canonical lane order for a family cut mixing distinct member
        policies (e.g. ``fora(interval=1)`` + ``none``).

        Lane order inside one cut is semantically free — lanes run
        simultaneously and results map back per request — so the lanes
        are stable-sorted by policy value: the engine's jit signature
        then depends on the batch's policy *composition* only, never on
        arrival interleaving (one executable per composition instead of
        one per ordering).  Value-pure cuts (the common case) pass
        through untouched, and FIFO order is preserved within each
        policy value.
        """
        pols = [self.effective_policy(r) for r in reqs]
        if all(p == pols[0] for p in pols):
            return reqs
        order = sorted(range(len(reqs)), key=lambda i: repr(pols[i]))
        return [reqs[i] for i in order]
