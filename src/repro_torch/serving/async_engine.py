"""True async serving: a thread-safe submit path over ``DiffusionEngine``
(counterpart of ``repro.serving.async_engine``).

``AsyncDiffusionEngine`` wraps a (warmed) ``DiffusionEngine``:

* ``submit(request)`` is safe from any number of client threads and
  returns a ``concurrent.futures.Future`` immediately — it resolves to
  the request's ``DiffusionResult`` when its batch completes (or raises
  the batch's exception / ``CancelledError`` on a no-drain shutdown).
  It takes the same ``DiffusionRequest`` object as the sync
  ``DiffusionEngine.submit`` / ``run_batch(reqs=...)`` path — one
  request type across both APIs — so per-request quality SLOs
  (``max_error``) and load-shedding behave identically: budget
  stamping and shedding happen inside ``Scheduler.submit``, which both
  routes share.
* one background worker thread owns the whole batch-formation →
  ``execute_plan`` loop.  It blocks on the scheduler's condition
  variable and wakes on submits or exactly when age/deadline pressure
  would cut a batch (``Scheduler.seconds_until_ready``) — no
  sleep-polling, and deadline-lapsed requests are promoted into the
  next cut by the scheduler.  Under a policy-grouping scheduler the
  worker executes one plan per compatibility group back to back (each
  cut is policy-pure; a drain flushes the remaining groups one cut at
  a time), so clients of different policies never share — or pay for —
  each other's activations.
* results stream back as batches complete: each future is resolved by
  the worker the moment its batch's device work finishes, so clients
  overlap the engine instead of replaying a plan serially.
* on a CUDA engine the kernels are built in the caller's thread (by
  ``warmup``, else by ``start``), never by the worker, and the worker
  selects the engine's device before its first launch.  A batch that
  raises resolves its futures with that exception and the worker keeps
  serving; nothing is retried, on the card or on the CPU.

Lock discipline: the scheduler's ``cv`` guards the queue *and* this
engine's future map / lifecycle flags; kernel launches, device
transfers and metrics recording happen outside the lock (metrics carry
their own lock).  ``drain()`` waits for everything submitted so far;
``shutdown`` (also via context manager) stops the worker, by default
draining first — no request is ever lost or double-served (futures
resolve exactly once, enforced by ``Future`` itself).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError  # noqa: F401  (re-export)
from concurrent.futures import Future, InvalidStateError, wait
from typing import List, Optional, Sequence

import torch

from repro_torch.serving.engine import DiffusionEngine
from repro_torch.serving.scheduler import DiffusionRequest

__all__ = ["AsyncDiffusionEngine", "CancelledError"]


class AsyncDiffusionEngine:
    """Threaded submit path + single worker around a ``DiffusionEngine``.

    Construct over an existing engine (warm it first), then either use
    as a context manager or call ``start()`` / ``shutdown()``
    explicitly::

        eng = DiffusionEngine(...)
        eng.warmup()
        with AsyncDiffusionEngine(eng) as aeng:
            futs = [aeng.submit(req) for req in reqs]   # any thread(s)
            outs = [f.result() for f in futs]
    """

    def __init__(self, engine: DiffusionEngine):
        self.engine = engine
        self.scheduler = engine.scheduler
        self.metrics = engine.metrics
        self._futures = {}            # id(request) -> Future (queued)
        self._inflight = {}           # id(request) -> Future (running batch)
        self._stop = False
        self._drains = 0              # drains in progress (flush mode)
        self._worker: Optional[threading.Thread] = None
        self._t0: Optional[float] = None
        self._cuda_index: Optional[int] = None   # set by start()

    # --- lifecycle -------------------------------------------------------
    def start(self) -> "AsyncDiffusionEngine":
        dev = self.engine.device
        if dev.type == "cuda":
            from repro_torch.kernels import build
            build.build()     # no-op once warmup has built them
            # ``cuda`` without an index is the caller's current device
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())
        with self.scheduler.cv:
            if self._stop:
                raise RuntimeError("engine has been shut down")
            if self._worker is None:
                self._t0 = time.perf_counter()
                self._worker = threading.Thread(
                    target=self._run, name="diffusion-engine-worker",
                    daemon=True)
                self._worker.start()
        return self

    def __enter__(self) -> "AsyncDiffusionEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               lane_policy_sets: Sequence[Sequence[object]] = (),
               policies: Sequence[object] = (),
               shapes: Sequence = ()) -> float:
        return self.engine.warmup(buckets, lane_policy_sets,
                                  policies=policies, shapes=shapes)

    def metrics_dict(self):
        """Fleet-export hook: lossless snapshot of the shared metrics."""
        return self.engine.metrics_dict()

    # --- submit path -----------------------------------------------------
    def submit(self, req: DiffusionRequest,
               now: Optional[float] = None) -> Future:
        """Enqueue a request; returns its future immediately.

        Thread-safe.  The future resolves to a ``DiffusionResult`` when
        the request's batch completes.
        """
        fut: Future = Future()
        with self.scheduler.cv:
            if self._stop:
                raise RuntimeError("engine has been shut down")
            if id(req) in self._futures or id(req) in self._inflight:
                raise ValueError(
                    "request object is already pending; submit a fresh "
                    "DiffusionRequest per attempt")
            if self._worker is None:
                self.start()
            # submit BEFORE registering the future: scheduler.submit
            # validates shapes and may raise (ShapeMismatchError) — the
            # future map must not keep an entry for a rejected request.
            # Safe under the reentrant cv: the worker can't observe the
            # queued-but-unregistered state until we release the lock.
            self.scheduler.submit(req, now=now)   # notifies the worker
            self._futures[id(req)] = fut
        return fut

    def pending(self) -> int:
        """Requests submitted but not yet resolved (queued + in flight).
        A batch's futures resolve before the worker clears its in-flight
        map, so an in-flight future that is done is not counted."""
        with self.scheduler.cv:
            return len(self._futures) + sum(
                not f.done() for f in self._inflight.values())

    # --- drain / shutdown ------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until everything submitted so far has resolved.

        Wakes the worker in flush mode so a waiting partial batch is cut
        immediately instead of aging out.  Returns False on timeout.
        """
        with self.scheduler.cv:
            outstanding = (list(self._futures.values())
                           + list(self._inflight.values()))
            self._drains += 1         # refcount: concurrent drains stack
            self.scheduler.cv.notify_all()
        try:
            done, not_done = wait(outstanding, timeout=timeout)
        finally:
            with self.scheduler.cv:
                self._drains -= 1
        return not not_done

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the worker.  ``drain=True`` serves everything already
        queued first; ``drain=False`` cancels queued requests (their
        futures raise ``CancelledError``).  Idempotent."""
        with self.scheduler.cv:
            self._stop = True
            if not drain:
                for r in list(self.scheduler.queue):
                    fut = self._futures.pop(id(r), None)
                    if fut is not None:
                        fut.cancel()
                self.scheduler.queue.clear()
            self.scheduler.cv.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join(timeout)
            if worker.is_alive():
                raise TimeoutError("engine worker did not stop in "
                                   f"{timeout}s")

    # --- worker ----------------------------------------------------------
    def _run(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        sched = self.scheduler
        while True:
            with sched.cv:
                plan = None
                while plan is None:
                    if not sched.queue:
                        if self._stop:
                            return
                        sched.cv.wait()
                        continue
                    flush = self._stop or self._drains > 0
                    self.metrics.observe_queue_depth(len(sched.queue))
                    plan = sched.form_batch(flush=flush)
                    if plan is None:
                        # deadline-aware nap: wake exactly when age or a
                        # deadline would cut (or earlier, on a submit)
                        sched.cv.wait(sched.seconds_until_ready())
                # a future whose client already cancelled it is dropped
                # here (its lane still runs — the plan is cut); the rest
                # move to RUNNING so late cancels can no longer race the
                # worker's set_result
                futs = []
                for r in plan.requests:
                    fut = self._futures.pop(id(r), None)
                    if fut is not None and \
                            not fut.set_running_or_notify_cancel():
                        fut = None
                    futs.append(fut)
                    if fut is not None:
                        self._inflight[id(r)] = fut
            try:
                self._serve(plan, futs)
            finally:
                with sched.cv:
                    self._inflight.clear()

    def _serve(self, plan, futs: List[Optional[Future]]) -> None:
        try:
            results = self.engine.execute_plan(plan)
        except BaseException as e:   # resolve, don't kill the worker
            for fut in futs:
                if fut is not None and not fut.done():
                    fut.set_exception(e)
            if not isinstance(e, Exception):
                raise                # an exit or interrupt still stops it
            return
        if self._t0 is not None:
            self.metrics.observe_first_result(time.perf_counter() - self._t0)
        for fut, res in zip(futs, results, strict=True):
            if fut is None:
                continue
            try:
                fut.set_result(res)
            except InvalidStateError:
                # the future moved to RUNNING above, so a client cancel
                # can't race us — but a second resolution must degrade
                # to a counter, never kill the worker thread
                self.metrics.observe_duplicate_result()
