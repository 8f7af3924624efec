"""Replica supervision: restart dead workers, retire crash-loopers (a
copy of ``repro.serving.fleet.supervisor``; framework-free).

``FleetSupervisor`` watches a ``FleetRouter``'s replica slots from its
own thread.  When a slot goes dead (crash, SIGKILL, stale-pong kill —
anything that tripped the router's death path) it schedules a restart
with exponential backoff (``backoff_base_s * 2**attempts``, capped at
``backoff_cap_s``), spawns a fresh ``Replica`` from the router's
stored factory/warm/env via ``FleetRouter._spawn_replica`` (so the
fault injector sees the new incarnation number), waits for it to boot
+ warm, and adopts it back into the slot — at which point the router
routes to it again and re-places any parked work.

Attempts are counted per slot over the fleet's lifetime: once a slot
has consumed ``max_restarts`` attempts (successful or not) and dies
again, it is **retired** — permanently removed from supervision — so a
crash-looping replica cannot burn the fleet forever.  Counters:
``restarts`` (successful adoptions), ``boot_failures`` (restart
attempts whose worker never became ready), ``replicas_retired``, and
``restart_backoff_s`` (cumulative scheduled backoff).

Lock discipline: the supervisor takes the router's lock only for
short state snapshots / adoption, and never holds its own state while
doing so — there is no router-lock → supervisor-lock edge, so the
runtime lock-order sanitizer stays quiet.  ``can_recover`` is
deliberately lock-free (reads a set maintained by the supervisor
thread) because the router calls it while holding its own lock.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

__all__ = ["FleetSupervisor"]


class FleetSupervisor:
    """Restart dead replica slots with capped exponential backoff.

    Created (and started) by ``FleetRouter.start`` when the router is
    constructed with ``max_restarts > 0``; usable standalone against
    any started router.
    """

    def __init__(self, router, max_restarts: int = 2,
                 backoff_base_s: float = 0.5, backoff_cap_s: float = 30.0,
                 poll_interval_s: float = 0.1):
        if max_restarts < 1:
            raise ValueError(
                f"max_restarts must be >= 1, got {max_restarts}")
        self.router = router
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.poll_interval_s = poll_interval_s
        # slot idx -> {"attempts": int, "next_try": float | None}
        # (touched only by the supervisor thread)
        self._slots: Dict[int, dict] = {}
        self.retired_slots: set = set()
        self.counters: Dict[str, int] = {
            "restarts": 0, "boot_failures": 0, "replicas_retired": 0,
        }
        self.restart_backoff_s = 0.0
        self._stop = threading.Event()
        self._thread = None

    # --- lifecycle -------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fleet-supervisor", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    # --- policy ----------------------------------------------------------
    def backoff_s(self, attempts: int) -> float:
        """Backoff before attempt ``attempts`` (0-based): base·2^k, capped."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempts))

    def can_recover(self) -> bool:
        """True while some slot could still come (back) up — the router
        parks orphans instead of failing them when this holds.  Lock-free
        on purpose: called under the router's lock."""
        return len(self.retired_slots) < self.router.n_replicas

    def state(self) -> Dict:
        """Counters + per-slot attempt/retire view (for status/benches)."""
        return {
            **self.counters,
            "restart_backoff_s": round(self.restart_backoff_s, 3),
            "retired_slots": sorted(self.retired_slots),
            "slots": {idx: {"attempts": s["attempts"],
                            "retired": idx in self.retired_slots}
                      for idx, s in self._slots.items()},
        }

    # --- supervision loop ------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self._tick()
            except Exception:
                # supervision must outlive any single bad tick
                continue

    def _dead_slots(self):
        with self.router._lock:
            if self.router._stopping:
                return None
            return [r.idx for r in self.router.replicas
                    if not r.healthy and not r.stopped]

    def _tick(self) -> None:
        dead = self._dead_slots()
        if dead is None:        # router shutting down
            return
        now = time.monotonic()
        for idx in dead:
            if idx in self.retired_slots:
                continue
            slot = self._slots.setdefault(
                idx, {"attempts": 0, "next_try": None})
            if slot["attempts"] >= self.max_restarts:
                self.retired_slots.add(idx)
                self.counters["replicas_retired"] += 1
                continue
            if slot["next_try"] is None:
                wait = self.backoff_s(slot["attempts"])
                slot["next_try"] = now + wait
                self.restart_backoff_s += wait
                continue
            if now < slot["next_try"]:
                continue
            slot["attempts"] += 1
            slot["next_try"] = None
            if self._restart(idx):
                self.counters["restarts"] += 1
            else:
                self.counters["boot_failures"] += 1
                wait = self.backoff_s(slot["attempts"])
                slot["next_try"] = time.monotonic() + wait
                self.restart_backoff_s += wait

    def _restart(self, idx: int) -> bool:
        """One restart attempt for slot ``idx``; True once the new
        worker is ready and adopted by the router."""
        router = self.router
        old = router.replicas[idx]
        old.destroy()           # reap the corpse, close its pipe fds
        try:
            r = router._spawn_replica(idx)
        except Exception:
            return False
        # wait_ready in slices so stop() interrupts a long warmup wait
        deadline = time.monotonic() + router.boot_timeout_s
        while True:
            if self._stop.is_set() or router._stopping:
                r.destroy()
                return False
            try:
                r.wait_ready(min(0.25, max(deadline - time.monotonic(),
                                           0.01)))
                break
            except TimeoutError:
                if time.monotonic() >= deadline:
                    r.destroy()
                    return False
            except Exception:   # boot_error / protocol violation
                r.destroy()
                return False
        router._adopt(idx, r)
        return True
