"""Deterministic fault injection at the ``Replica``/pipe boundary (a
copy of ``repro.serving.fleet.faults``; framework-free).

A ``FaultInjector`` holds *scripted* rules keyed by ``(slot, start_n)``
— the replica slot index and which incarnation of that slot is booting
(0 = initial boot, 1 = first supervisor restart, ...).  The router
calls :meth:`spec_for` once per spawn and ships the resulting plain
dict to the child alongside the factory payload; ``worker_main``
consults it at the matching protocol points:

``boot_fail``
    The worker reports ``("boot_error", ...)`` and exits before
    touching the factory — the never-became-ready case the router's
    boot-cleanup and the supervisor's backoff path must absorb.
``boot_hang_s``
    The worker sleeps *before* sending ``ready`` (and before loading
    the factory payload, so the hang is prompt and cheap) — the
    boot-timeout case.
``kill_after_submits``
    ``os._exit`` the instant the N-th ``submit`` command arrives —
    byte-for-byte the SIGKILL crash case (no drain, no goodbye, the
    pipe just EOFs) but deterministic in the request stream.
``kill_on_request_id``
    ``os._exit`` on receipt of the submit carrying this
    ``request_id`` — a *poison request*: every replica it reaches
    dies, which is exactly what the router's retry budget and
    quarantine must contain.
``ignore_pings_after``
    Stop answering pings after the N-th — the alive-but-hung worker
    the monitor's stale-pong kill exists for.  The worker keeps
    serving; only its health channel goes dark.
``result_delay_s``
    Sleep before each result send — delayed delivery, for racing the
    death path against late results.

Everything is deterministic: rules are scripted, and the only sampled
quantity (the optional delivery-delay jitter) is drawn from a
``random.Random`` seeded by ``(seed, slot, start_n)``, so the same
injector configuration replays the same fault schedule run after run.
"""
from __future__ import annotations

import random
from typing import List, Optional, Tuple

__all__ = ["FaultInjector"]


class FaultInjector:
    """Scripted fault plan for a fleet; see module docstring.

    Rule methods return ``self`` so plans chain::

        faults = (FaultInjector(seed=0)
                  .kill_after_submits(3, slot=0, start_n=0)
                  .fail_boot(slot=0, start_n=1))

    ``slot=None`` / ``start_n=None`` match every slot / incarnation.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        # (slot | None, start_n | None, spec key, value)
        self._rules: List[Tuple[Optional[int], Optional[int], str,
                                object]] = []

    def _add(self, slot: Optional[int], start_n: Optional[int],
             key: str, value) -> "FaultInjector":
        self._rules.append((slot, start_n, key, value))
        return self

    # --- boot faults -----------------------------------------------------
    def fail_boot(self, slot: Optional[int] = None,
                  start_n: Optional[int] = None) -> "FaultInjector":
        """Worker reports ``boot_error`` instead of becoming ready."""
        return self._add(slot, start_n, "boot_fail", True)

    def hang_boot(self, hang_s: float, slot: Optional[int] = None,
                  start_n: Optional[int] = None) -> "FaultInjector":
        """Worker sleeps ``hang_s`` before ``ready`` (boot timeout)."""
        return self._add(slot, start_n, "boot_hang_s", float(hang_s))

    # --- crash faults ----------------------------------------------------
    def kill_after_submits(self, n: int, slot: Optional[int] = None,
                           start_n: Optional[int] = None
                           ) -> "FaultInjector":
        """Worker ``os._exit``\\ s when its ``n``-th submit arrives."""
        return self._add(slot, start_n, "kill_after_submits", int(n))

    def kill_on_request(self, request_id: int,
                        slot: Optional[int] = None,
                        start_n: Optional[int] = None) -> "FaultInjector":
        """Worker dies on receipt of this request — a poison request."""
        return self._add(slot, start_n, "kill_on_request_id",
                         int(request_id))

    # --- hang / delay faults ---------------------------------------------
    def mute_pings_after(self, n: int, slot: Optional[int] = None,
                         start_n: Optional[int] = None) -> "FaultInjector":
        """Worker stops ponging after its ``n``-th ping (hung-alive)."""
        return self._add(slot, start_n, "ignore_pings_after", int(n))

    def delay_results(self, delay_s: float, jitter_s: float = 0.0,
                      slot: Optional[int] = None,
                      start_n: Optional[int] = None) -> "FaultInjector":
        """Sleep before each result send (+ seeded deterministic
        jitter), delaying delivery without harming the worker."""
        return self._add(slot, start_n, "result_delay_s",
                         (float(delay_s), float(jitter_s)))

    # --- resolution ------------------------------------------------------
    def spec_for(self, slot: int, start_n: int) -> dict:
        """The fault spec one spawn of ``slot``'s ``start_n``-th
        incarnation should carry: a plain picklable dict (later rules
        win on key collisions).  Deterministic in (seed, slot,
        start_n)."""
        spec: dict = {}
        for s, n, key, value in self._rules:
            if (s is not None and s != slot) or \
                    (n is not None and n != start_n):
                continue
            if key == "result_delay_s":
                base, jitter = value
                if jitter:
                    rng = random.Random(
                        self.seed * 1_000_003 + slot * 1_009 + start_n)
                    base += rng.uniform(0.0, jitter)
                value = base
            spec[key] = value
        return spec
