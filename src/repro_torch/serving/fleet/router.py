"""Policy-aware request router over N engine replicas (the port's
counterpart of ``repro.serving.fleet.router``).

``FleetRouter`` is the fleet analogue of ``AsyncDiffusionEngine``:
``submit(request)`` is thread-safe and returns a
``concurrent.futures.Future`` immediately; ``drain()`` waits for
everything submitted so far (flushing partial batches on every
replica); ``shutdown(drain=True)`` stops the workers gracefully
(``drain=False`` cancels outstanding futures and terminates).  The
difference is *where* batches form: the router never cuts batches
itself — each replica runs its own ``Scheduler`` — so the router's job
is to place requests such that the per-replica schedulers still see
policy-pure streams.

**Routing rule** (compatibility-key affinity + load):  each request is
keyed by its resolved policy's ``compatibility_key()`` with the
``max_error`` budget tier folded in (``Policy.with_budget`` — the same
key the replica's scheduler groups by).  A group has a *home* replica;
requests follow their home while it stays healthy and within
``spill_slack`` outstanding requests of the least-loaded replica, so a
group's requests pile onto ONE queue and fill policy-pure buckets
fleet-wide instead of fragmenting into per-replica singles.  When the
home falls behind by more than ``spill_slack`` (default: the replica's
``max_batch`` — one full bucket of slack), the group *spills*: the
least-loaded replica becomes the new home.  New groups start on the
least-loaded replica; a group whose home died also counts as a spill.
Decisions are counted
(``affinity_hits`` / ``new_groups`` / ``spills`` / ``requeued``) and
reported through ``FleetMetrics``.

**Health / failure**:  a monitor thread pings every replica on
``health_interval_s``; one receiver thread per replica streams results
back and resolves futures.  A dead replica is detected by pipe EOF
(crash/SIGKILL) or a stale pong (hung worker — it is then killed
exactly once, counted in ``stale_pong_kills``, so the EOF path takes
over).  Death handling runs on the receiver thread *after* the pipe
buffer is fully drained, so results that raced the crash still
resolve; everything left in the replica's in-flight map is requeued
onto the surviving replicas (sampling is deterministic per request
seed, so a re-run resolves to the same latents) and each future still
resolves exactly once.

**Self-healing** (``max_restarts > 0``):  a ``FleetSupervisor`` thread
restarts dead slots with capped exponential backoff and permanently
retires crash-loopers; while recovery is possible, orphans that find
no healthy survivor are *parked* and re-placed the moment a replica
rejoins, instead of failing.  Only when no slot can ever come back do
orphaned futures fail with ``RuntimeError``.

**Retry budget / poison quarantine**:  each in-flight entry carries a
death count.  A request implicated in ``retry_budget`` replica deaths
is quarantined — its future fails with ``PoisonRequestError`` — but
only when the evidence is unambiguous: it was *alone* on the replica
it killed.  A request that reaches its budget in a cohort (other
requests died with it — any of them could be the poison) is parked for
an **isolation probe**: it re-runs solo on an idle replica flagged
``probation`` (excluded from routing), so a genuinely healthy
bystander completes its probe and resolves normally, while a true
poison kills the probation replica solo and is then quarantined.
Healthy traffic can therefore never be failed by someone else's
poison.

**Backpressure** (``max_inflight > 0``):  ``submit()`` blocks while
every healthy replica has ``max_inflight`` requests outstanding, so
router-side queues are bounded by ``replicas × max_inflight`` instead
of growing without limit.  With ``shed_factor`` set, a blocked submit
first relaxes the request's error budget once (``max_error ×
shed_factor`` — the scheduler's quality-shed move: cheaper to serve
slightly coarser than to queue unboundedly) and then waits for a slot.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional

from repro_torch.analysis.runtime import make_condition, make_lock
from repro_torch.serving.fleet.fleet_metrics import FleetMetrics
from repro_torch.serving.fleet.worker import Replica
from repro_torch.serving.scheduler import (DiffusionRequest,
                                           ShapeMismatchError,
                                           resolve_shape_key,
                                           validate_request_shape)

__all__ = ["FleetRouter", "PoisonRequestError", "ShapeMismatchError"]


class PoisonRequestError(RuntimeError):
    """The request was implicated — solo — in ``retry_budget`` replica
    deaths and has been quarantined instead of requeued again."""


def _wire_request(req: DiffusionRequest) -> DiffusionRequest:
    """Copy with ``init_latents`` as a host numpy array, so the request
    pickles by value: a torch tensor would cross the pipe through torch's
    reducers (shared memory, or CUDA IPC for a tensor on the card, which
    would land on the card again in the worker)."""
    if req.init_latents is None:
        return req
    import numpy as np
    import torch
    lat = req.init_latents
    if isinstance(lat, torch.Tensor):
        lat = lat.detach().cpu().numpy()
    return dataclasses.replace(req, init_latents=np.asarray(lat))


def _entry_deaths(entry) -> int:
    """Death count of an in-flight entry; tolerates legacy 2-tuples
    (tests that hand-build fake replicas with ``(req, fut)``)."""
    return entry[2] if len(entry) > 2 else 0


class FleetRouter:
    """Frontend over N replica processes (see module docstring).

    ``factory`` must be a picklable zero-arg callable returning an
    (unwarmed) ``DiffusionEngine`` — a module-level function or a
    ``functools.partial`` of one; each worker calls it in its own
    process.  ``warm`` maps onto ``DiffusionEngine.warmup`` kwargs and
    runs once per replica at boot.  ``default_policy`` mirrors the
    engines' default and is only used to compute affinity keys for
    requests with ``policy=None``.

    Robustness knobs (all off by default, the unsupervised fleet):
    ``max_restarts`` enables the supervisor; ``max_inflight`` bounds
    per-replica queues (0 = unbounded); ``retry_budget`` is the number
    of replica deaths a single request may be implicated in before
    quarantine; ``shed_factor`` (> 1) relaxes a blocked request's error
    budget once instead of queueing it forever; ``fault_injector`` is
    the chaos hook (tests/benches only).
    """

    def __init__(self, factory, n_replicas: int = 2, warm: Optional[dict]
                 = None, default_policy=None, worker_env: Optional[dict]
                 = None, spill_slack: Optional[int] = None,
                 health_interval_s: float = 0.25,
                 stale_after_s: float = 30.0,
                 boot_timeout_s: float = 600.0,
                 max_inflight: int = 0,
                 max_restarts: int = 0,
                 retry_budget: int = 2,
                 shed_factor: Optional[float] = None,
                 restart_backoff_base_s: float = 0.5,
                 restart_backoff_cap_s: float = 30.0,
                 fault_injector=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if retry_budget < 1:
            raise ValueError(f"retry_budget must be >= 1, got {retry_budget}")
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, got {max_inflight}")
        self.factory = factory
        self.n_replicas = n_replicas
        self.warm = dict(warm or {})
        self.default_policy = default_policy
        self.worker_env = dict(worker_env or {})
        self.spill_slack = spill_slack
        self.health_interval_s = health_interval_s
        self.stale_after_s = stale_after_s
        self.boot_timeout_s = boot_timeout_s
        self.max_inflight = max_inflight
        self.max_restarts = max_restarts
        self.retry_budget = retry_budget
        self.shed_factor = shed_factor
        self.restart_backoff_base_s = restart_backoff_base_s
        self.restart_backoff_cap_s = restart_backoff_cap_s
        self.fault_injector = fault_injector

        self.replicas: List[Replica] = []
        self.supervisor = None
        self._lock = make_lock("FleetRouter._lock")
        self._cv = make_condition("FleetRouter._cv", lock=self._lock)
        self._home: Dict = {}         # affinity key -> replica idx
        self._key_cache: Dict = {}    # (policy, budget, shapes) -> key
        # shape ladder shared by the replicas (all run the same factory
        # + warm spec): learned from the first replica's ready metadata,
        # used to validate submits at the router boundary and to fold
        # shape into affinity keys.  None with pre-multires workers.
        self._default_shape = None
        self._shape_ladder = None
        self._starts: Dict[int, int] = {}   # slot idx -> spawn count
        self._parked: List[list] = []  # [req, fut, deaths, probe_flag]
        self._next_token = 0
        self._stopping = False
        self._started = False
        self._stop_monitor = threading.Event()
        self._threads: List[threading.Thread] = []
        self.counters: Dict[str, int] = {
            "submitted": 0, "resolved": 0, "failed": 0,
            "affinity_hits": 0, "new_groups": 0, "spills": 0,
            "requeued": 0, "replicas_lost": 0, "duplicate_results": 0,
            "stale_pong_kills": 0, "poison_quarantined": 0,
            "probations": 0, "backpressure_waits": 0,
            "router_shed_events": 0, "peak_inflight": 0,
        }

    # --- lifecycle -------------------------------------------------------
    def _spawn_replica(self, idx: int) -> Replica:
        """Spawn one replica for slot ``idx``; each call is a new
        incarnation (``start_n``) so the fault injector can script
        boot-failure-on-Nth-start."""
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        start_n = self._starts.get(idx, 0)
        self._starts[idx] = start_n + 1
        fault = (self.fault_injector.spec_for(idx, start_n)
                 if self.fault_injector is not None else None)
        return Replica(idx, self.factory, warm=self.warm,
                       env=self.worker_env, ctx=ctx, fault=fault,
                       start_n=start_n)

    def _start_recv(self, r: Replica) -> None:
        th = threading.Thread(target=self._recv_loop, args=(r,),
                              name=f"fleet-recv-{r.idx}", daemon=True)
        th.start()
        self._threads.append(th)

    def start(self) -> "FleetRouter":
        """Spawn all replicas (they boot + warm in parallel), wait until
        every one is ready, then start the receiver/monitor threads
        (and the supervisor, when ``max_restarts > 0``)."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("router has been shut down")
            if self._started:
                return self
            self._started = True
        self.replicas = [self._spawn_replica(i)
                         for i in range(self.n_replicas)]
        deadline = time.monotonic() + self.boot_timeout_s
        try:
            for r in self.replicas:
                r.wait_ready(max(deadline - time.monotonic(), 0.1))
        except BaseException:
            # never leak a stuck child: kill + reap + close every pipe
            for r in self.replicas:
                r.destroy()
            raise
        if self.spill_slack is None:
            self.spill_slack = max(r.meta.get("max_batch", 1)
                                   for r in self.replicas)
        meta0 = self.replicas[0].meta
        if meta0.get("shapes"):
            self._shape_ladder = {
                (tuple(s[0]), tuple(s[1])) for s in meta0["shapes"]}
        if meta0.get("default_shape"):
            ds = meta0["default_shape"]
            self._default_shape = (tuple(ds[0]), tuple(ds[1]))
        for r in self.replicas:
            self._start_recv(r)
        mon = threading.Thread(target=self._monitor, name="fleet-monitor",
                               daemon=True)
        mon.start()
        self._threads.append(mon)
        if self.max_restarts > 0:
            from repro_torch.serving.fleet.supervisor import FleetSupervisor
            self.supervisor = FleetSupervisor(
                self, max_restarts=self.max_restarts,
                backoff_base_s=self.restart_backoff_base_s,
                backoff_cap_s=self.restart_backoff_cap_s).start()
        return self

    def _adopt(self, idx: int, r: Replica) -> None:
        """Swap a freshly-booted replica into slot ``idx`` (supervisor
        restart path) and re-place any parked work on it."""
        with self._cv:
            self.replicas[idx] = r
            self._cv.notify_all()   # blocked submits: capacity is back
        self._start_recv(r)
        self._place_parked()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    # --- routing ---------------------------------------------------------
    def _affinity_key(self, req: DiffusionRequest):
        """The cut key the replica's scheduler will file this request
        under: (resolved policy with budget tier folded in, canonical
        shape key) — mirroring ``Scheduler._cut_key``, so a
        (policy, shape) group piles onto ONE replica and fills
        shape-pure buckets fleet-wide."""
        pol = req.policy if req.policy is not None else self.default_policy
        lat = (tuple(req.latent_shape)
               if req.latent_shape is not None else None)
        crf = tuple(req.crf_shape) if req.crf_shape is not None else None
        ck = (pol, req.max_error, lat, crf)
        key = self._key_cache.get(ck)
        if key is None:
            if pol is None:
                pkey = ("default", req.max_error)
            else:
                from repro_torch.core.policies import registry
                pkey = registry.compatibility_key(
                    registry.resolve(pol).with_budget(req.max_error))
            shape = resolve_shape_key(lat, crf, self._default_shape,
                                      self._shape_ladder)
            key = (pkey, shape)
            self._key_cache[ck] = key
        return key

    def _candidates(self, respect_cap: bool) -> List[Replica]:
        """Routable replicas: healthy, not running an isolation probe,
        and (for fresh submits) below ``max_inflight``."""
        return [r for r in self.replicas
                if r.healthy and not getattr(r, "probation", False)
                and (not respect_cap or self.max_inflight <= 0
                     or len(r.inflight) < self.max_inflight)]

    def _route(self, req: DiffusionRequest,
               respect_cap: bool = False) -> Replica:
        """Pick a replica (call with ``self._lock`` held)."""
        healthy = self._candidates(respect_cap)
        if not healthy:
            raise RuntimeError("no healthy replicas")
        key = self._affinity_key(req)
        least = min(healthy, key=lambda r: (len(r.inflight), r.idx))
        idx = self._home.get(key)
        home = next((r for r in healthy if r.idx == idx), None)
        if home is None:
            # brand-new group, or the home died / is at capacity —
            # either way the group moves to the least-loaded replica
            self._home[key] = least.idx
            self.counters["new_groups" if idx is None else "spills"] += 1
            return least
        if len(home.inflight) - len(least.inflight) <= self.spill_slack:
            self.counters["affinity_hits"] += 1
            return home
        self._home[key] = least.idx
        self.counters["spills"] += 1
        return least

    def _note_peak(self) -> None:
        """Track peak fleet-wide in-flight (call with lock held)."""
        total = sum(len(r.inflight) for r in self.replicas)
        if total > self.counters["peak_inflight"]:
            self.counters["peak_inflight"] = total

    def _validate_shape(self, req: DiffusionRequest) -> None:
        """Fail fast at the router boundary: a request whose declared
        shape is outside the fleet's ladder raises
        :class:`ShapeMismatchError` synchronously — before ``submitted``
        is counted, so ``submitted == resolved + failed`` holds without
        a round-trip to a replica (whose own scheduler would reject it
        anyway, but only after pickling + a pipe hop).  Skipped when the
        workers predate shape metadata."""
        if self._shape_ladder is None and self._default_shape is None:
            return
        validate_request_shape(req, self._default_shape,
                               self._shape_ladder)

    # --- submit path -----------------------------------------------------
    def submit(self, req: DiffusionRequest) -> Future:
        """Thread-safe; the future resolves to this request's
        ``DiffusionResult`` from whichever replica serves it (survivors
        included, if its first home dies mid-flight).  Blocks while
        every healthy replica is at ``max_inflight`` (after shedding
        quality once, if ``shed_factor`` is set).  Raises
        ``ShapeMismatchError`` for shapes outside the fleet's declared
        ladder — synchronously, before the request is counted."""
        fut: Future = Future()
        with self._cv:
            if not self._started:
                raise RuntimeError("router not started; call start()")
            self._validate_shape(req)
            blocked = shed = False
            while True:
                if self._stopping:
                    raise RuntimeError("router has been shut down")
                try:
                    r = self._route(req, respect_cap=True)
                    break
                except RuntimeError:
                    # nothing routable right now: at capacity, on
                    # probation, or awaiting a supervisor restart —
                    # block unless nobody is healthy AND nobody can
                    # ever come back
                    if not any(x.healthy for x in self.replicas) \
                            and not (self.supervisor is not None
                                     and self.supervisor.can_recover()):
                        raise RuntimeError("no healthy replicas") from None
                if not blocked:
                    blocked = True
                    self.counters["backpressure_waits"] += 1
                if self.shed_factor and not shed \
                        and req.max_error is not None:
                    # quality shed: one-shot budget relaxation beats an
                    # unbounded queue (coarser result now > timeout later)
                    req = dataclasses.replace(
                        req, max_error=req.max_error * self.shed_factor)
                    self.counters["router_shed_events"] += 1
                    shed = True
                self._cv.wait(0.05)
            self.counters["submitted"] += 1
            token = self._next_token
            self._next_token += 1
            r.inflight[token] = (req, fut, 0)
            self._note_peak()
        self._send_submit(r, token, req)
        return fut

    def _send_submit(self, r: Replica, token: int,
                     req: DiffusionRequest) -> None:
        try:
            r.send(("submit", token, _wire_request(req)))
        except (OSError, ValueError, BrokenPipeError):
            # the pipe died between routing and sending: run the death
            # path ourselves (idempotent) so this token is requeued too
            self._on_replica_down(r)

    def pending(self) -> int:
        with self._lock:
            return (sum(len(r.inflight) for r in self.replicas)
                    + len(self._parked))

    # --- receive / failure paths -----------------------------------------
    def _recv_loop(self, r: Replica) -> None:
        while True:
            try:
                msg = r.conn.recv()
            except (EOFError, OSError):
                break
            kind = msg[0]
            if kind == "result":
                self._finish(r, msg[1], value=msg[2])
            elif kind == "error":
                self._finish(r, msg[1], exc=msg[2])
            elif kind == "pong":
                r.last_pong = time.monotonic()
            elif kind == "metrics":
                r.metrics_box.append(msg[1])
                r.metrics_event.set()
            elif kind == "stopping":
                with self._lock:
                    r.stopped = True
                    r.healthy = False
        # EOF only after the buffer is drained: any result that raced a
        # crash has already resolved its future above
        self._on_replica_down(r)

    def _finish(self, r: Replica, token: int, value=None, exc=None) -> None:
        with self._cv:
            entry = r.inflight.pop(token, None)
            if entry is not None:
                self.counters["resolved" if exc is None else "failed"] += 1
                if getattr(r, "probation", False) and not r.inflight:
                    # the isolation probe came back: the replica
                    # survived, the request was a bystander — release
                    # the replica back into the routable pool
                    r.probation = False
            self._cv.notify_all()
        if entry is None:
            return                      # requeued or cancelled meanwhile
        fut = entry[1]
        if fut.cancelled():
            return
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:       # exactly-once guard, observable
            with self._lock:
                self.counters["duplicate_results"] += 1

    def _on_replica_down(self, r: Replica) -> None:
        """Mark ``r`` unhealthy and re-place its in-flight work: requeue
        under budget, quarantine solo killers at budget, park ambiguous
        cohort members for an isolation probe.  Idempotent; safe to call
        from any thread."""
        with self._cv:
            was_healthy = r.healthy
            r.healthy = False
            orphans = list(r.inflight.items())
            r.inflight.clear()
            if was_healthy and not r.stopped and not self._stopping:
                self.counters["replicas_lost"] += 1
            self._cv.notify_all()
        if self._stopping:
            for _, entry in orphans:
                entry[1].cancel()
            return
        solo = len(orphans) == 1
        for _, entry in orphans:
            req, fut = entry[0], entry[1]
            deaths = _entry_deaths(entry) + 1
            if fut.cancelled():
                continue
            if deaths >= self.retry_budget:
                if solo:
                    # unambiguous: it was alone on the replica it killed
                    with self._lock:
                        self.counters["poison_quarantined"] += 1
                    try:
                        fut.set_exception(PoisonRequestError(
                            f"request implicated solo in {deaths} replica "
                            f"deaths (budget {self.retry_budget}); "
                            "quarantined"))
                    except InvalidStateError:
                        pass
                    else:
                        with self._lock:
                            self.counters["failed"] += 1
                    continue
                # ambiguous: it died in a cohort — any member could be
                # the poison, so isolate instead of quarantining a
                # possibly-healthy bystander
                with self._cv:
                    self._parked.append([req, fut, deaths, True])
                    self.counters["probations"] += 1
                    self._cv.notify_all()
                continue
            self._requeue(req, fut, deaths)
        self._place_parked()

    def _requeue(self, req: DiffusionRequest, fut: Future,
                 deaths: int) -> None:
        """Re-place one orphan on a survivor; park it while recovery is
        possible, fail it only when no replica can ever come back."""
        try:
            with self._lock:
                nr = self._route(req)
                ntoken = self._next_token
                self._next_token += 1
                nr.inflight[ntoken] = (req, fut, deaths)
                self.counters["requeued"] += 1
                self._note_peak()
        except RuntimeError as e:       # no healthy replicas right now
            if self.supervisor is not None and self.supervisor.can_recover():
                with self._cv:
                    self._parked.append([req, fut, deaths, False])
                    self._cv.notify_all()
                return
            try:
                fut.set_exception(e)
            except InvalidStateError:
                pass
            else:
                with self._lock:
                    self.counters["failed"] += 1
            return
        self._send_submit(nr, ntoken, req)

    def _place_parked(self) -> None:
        """Try to place parked work: isolation probes onto an idle
        replica (flagged ``probation``), plain orphans onto any healthy
        survivor.  Called on monitor/drain ticks and at adoption."""
        placed = []
        with self._cv:
            if self._stopping or not self._parked:
                return
            doomed = []
            if not any(r.healthy for r in self.replicas) and (
                    self.supervisor is None
                    or not self.supervisor.can_recover()):
                # every slot is dead or retired: parked work can never
                # be placed — fail it instead of holding futures forever
                doomed, self._parked = self._parked, []
                self._cv.notify_all()
            remaining = []
            for entry in self._parked:
                req, fut, deaths, probe = entry
                if fut.cancelled():
                    continue
                if probe:
                    # probes must run SOLO: an idle, routable replica
                    cand = next(
                        (r for r in self.replicas
                         if r.healthy and not getattr(r, "probation", False)
                         and not r.inflight), None)
                    if cand is None:
                        remaining.append(entry)
                        continue
                    cand.probation = True
                    token = self._next_token
                    self._next_token += 1
                    cand.inflight[token] = (req, fut, deaths)
                    placed.append((cand, token, req))
                else:
                    try:
                        nr = self._route(req)
                    except RuntimeError:
                        remaining.append(entry)
                        continue
                    token = self._next_token
                    self._next_token += 1
                    nr.inflight[token] = (req, fut, deaths)
                    self.counters["requeued"] += 1
                    placed.append((nr, token, req))
            self._parked = remaining
            self._note_peak()
            if placed:
                self._cv.notify_all()
        for entry in doomed:
            try:
                entry[1].set_exception(RuntimeError(
                    "no healthy replicas and no recovery possible"))
            except InvalidStateError:
                pass
            else:
                with self._lock:
                    self.counters["failed"] += 1
        for r, token, req in placed:
            self._send_submit(r, token, req)

    def _monitor(self) -> None:
        seq = 0
        while not self._stop_monitor.wait(self.health_interval_s):
            self._place_parked()
            for r in self.replicas:
                if not r.healthy or getattr(r, "kill_requested", False):
                    continue
                seq += 1
                try:
                    r.send(("ping", seq))
                except (OSError, ValueError, BrokenPipeError):
                    continue            # receiver thread handles the EOF
                stale = time.monotonic() - r.last_pong
                if stale > self.stale_after_s:
                    # alive-but-unresponsive: kill once (latched), so the
                    # EOF path (buffer-drain then requeue) takes over
                    if r.kill():
                        with self._lock:
                            self.counters["stale_pong_kills"] += 1

    # --- drain / shutdown ------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every future submitted so far has resolved —
        parked work included, so a drain rides out a mid-stream replica
        restart.  Re-sends the flush on each wait tick, so partial
        batches formed *during* the drain are cut too.  False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._place_parked()
            with self._lock:
                replicas = [r for r in self.replicas if r.healthy]
            for r in replicas:
                try:
                    r.send(("drain",))
                except (OSError, ValueError, BrokenPipeError):
                    pass
            with self._cv:
                if not any(r.inflight for r in self.replicas) \
                        and not self._parked:
                    return True
                wait = 0.25
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cv.wait(wait)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the fleet.  ``drain=True`` serves everything already
        submitted first; ``drain=False`` cancels outstanding futures and
        terminates the workers.  Idempotent."""
        if drain and self._started and not self._stopping:
            self.drain(timeout)
        if self.supervisor is not None:
            self.supervisor.stop()      # no restarts while we tear down
        with self._lock:
            self._stopping = True
            orphans = [entry for r in self.replicas
                       for entry in r.inflight.values()]
            orphans += self._parked
            self._parked = []
            for r in self.replicas:
                r.inflight.clear()
                r.healthy = False
        self._stop_monitor.set()
        for entry in orphans:
            entry[1].cancel()
        for r in self.replicas:
            try:
                r.send(("stop",))
            except (OSError, ValueError, BrokenPipeError):
                pass
        join_s = 30.0 if timeout is None else timeout
        for r in self.replicas:
            r.proc.join(join_s)
            if r.proc.is_alive():
                r.kill()
                r.proc.join(5.0)

    # --- observability ---------------------------------------------------
    def status(self) -> Dict:
        with self._lock:
            out = {
                "replicas": [{
                    "idx": r.idx,
                    "pid": r.meta.get("pid"),
                    "alive": r.proc.is_alive(),
                    "healthy": r.healthy,
                    "probation": getattr(r, "probation", False),
                    "start_n": getattr(r, "start_n", 0),
                    "inflight": len(r.inflight),
                    "last_pong_age_s": round(
                        time.monotonic() - r.last_pong, 3),
                } for r in self.replicas],
                "healthy_replicas": sum(r.healthy for r in self.replicas),
                "parked": len(self._parked),
                "counters": dict(self.counters),
            }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.state()
        return out

    def replica_metrics(self, timeout: float = 30.0) -> Dict[int, dict]:
        """Latest ``ServeMetrics.to_dict()`` snapshot per live replica."""
        with self._lock:
            replicas = [r for r in self.replicas if r.healthy]
        for r in replicas:
            r.metrics_event.clear()
            try:
                r.send(("metrics",))
            except (OSError, ValueError, BrokenPipeError):
                pass
        out: Dict[int, dict] = {}
        for r in replicas:
            if r.metrics_event.wait(timeout) and r.metrics_box:
                out[r.idx] = r.metrics_box[-1]
        return out

    def fleet_metrics(self, timeout: float = 30.0) -> FleetMetrics:
        """Fleet-wide aggregation: merged ``ServeMetrics`` + per-replica
        occupancy/recompile breakdown + routing-decision counters (and
        supervision counters, when the supervisor is running).  The
        router's own wire-format counters ride along as ``router_snap``
        so they merge into the fleet ``ServeMetrics``."""
        snaps = self.replica_metrics(timeout)
        with self._lock:
            routing = dict(self.counters)
            meta = {r.idx: dict(r.meta) for r in self.replicas}
            router_snap = {
                "duplicate_results": self.counters["duplicate_results"],
                "stale_pong_kills": self.counters["stale_pong_kills"],
            }
        if self.supervisor is not None:
            sup = self.supervisor.state()
            routing.update({k: sup[k] for k in
                            ("restarts", "boot_failures",
                             "replicas_retired", "restart_backoff_s")})
        return FleetMetrics(snaps, routing=routing, meta=meta,
                            router_snap=router_snap)
