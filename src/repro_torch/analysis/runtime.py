"""Opt-in runtime lock-order sanitizer (``REPRO_SANITIZE=1``); a copy
of the lock half of ``repro.analysis.runtime``.

``make_lock``/``make_rlock``/``make_condition`` are the serving stack's
lock constructors.  With sanitizing off (the default) they return plain
``threading`` primitives — zero overhead, nothing imported beyond
``threading``.  With ``REPRO_SANITIZE=1`` they return instrumented
wrappers that maintain (a) a per-thread stack of held locks and (b) a
global acquisition-order graph (edge ``H -> N`` the first time ``N`` is
acquired while ``H`` is held).  An ``acquire`` whose edge would close a
cycle raises :class:`LockOrderError` *before* blocking — the test fails
with the two offending orders named instead of deadlocking until the CI
timeout.

The reference's second checker, the tracer-leak sanitizer, looks for
JAX tracers and has no counterpart here.

The env flag is read at *call* time: tests flip it with ``monkeypatch``
and construct fresh locks.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.graphs import would_close_cycle

__all__ = [
    "enabled", "make_lock", "make_rlock", "make_condition",
    "LockOrderError", "order_graph", "reset_order_graph",
]


def enabled() -> bool:
    """Sanitizers on?  Read per call — never frozen at import."""
    return os.environ.get("REPRO_SANITIZE", "") == "1"


class LockOrderError(RuntimeError):
    """A lock acquisition would invert an already-observed order."""


# --- lock-order sanitizer ------------------------------------------------

# observed acquisition edges: name -> set of names acquired while held
_graph: Dict[str, Set[str]] = {}
_graph_lock = threading.Lock()
_tls = threading.local()


def _held() -> List[Tuple[str, int]]:
    """This thread's stack of (lock name, reentrancy count)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def order_graph() -> Dict[str, Set[str]]:
    """Snapshot of the observed acquisition-order graph (for tests)."""
    with _graph_lock:
        return {k: set(v) for k, v in _graph.items()}


def reset_order_graph() -> None:
    with _graph_lock:
        _graph.clear()


def _before_acquire(name: str) -> None:
    """Record edges held -> name; raise if one would close a cycle.

    Raises *before* the underlying acquire so the offending ``with``
    block never enters and outer locks unwind cleanly.
    """
    stack = _held()
    if any(n == name for n, _ in stack):
        return   # reentrant re-acquire of an RLock: no new edge
    with _graph_lock:
        for held_name, _count in stack:
            if would_close_cycle(_graph, held_name, name):
                # name -> ... -> held_name already observed; adding
                # held_name -> name completes the inversion
                raise LockOrderError(
                    f"lock-order inversion: acquiring {name!r} while "
                    f"holding {held_name!r}, but the opposite order "
                    f"was already observed (graph: "
                    f"{sorted(_graph.get(name, ()))} reachable from "
                    f"{name!r})")
        for held_name, _count in stack:
            _graph.setdefault(held_name, set()).add(name)


def _push(name: str) -> None:
    stack = _held()
    for i, (n, count) in enumerate(stack):
        if n == name:
            stack[i] = (n, count + 1)
            return
    stack.append((name, 1))


def _pop(name: str) -> None:
    stack = _held()
    for i in range(len(stack) - 1, -1, -1):
        n, count = stack[i]
        if n == name:
            if count > 1:
                stack[i] = (n, count - 1)
            else:
                del stack[i]
            return


class _TrackedLock:
    """Instrumented lock: delegates to an inner primitive, maintains
    the held-stack and order graph.  Quacks enough like an ``RLock``
    for ``threading.Condition`` to wrap it (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``)."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        _before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _push(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _pop(self.name)

    __enter__ = acquire

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration -------------------------------------------
    # Condition(lock) calls these on wait(): the lock is fully released
    # while waiting, so the held-stack must drop it and re-add it on
    # wake — without re-checking order (a wakeup re-acquire is not a
    # new ordering decision).
    def _release_save(self):
        saver = getattr(self._inner, "_release_save", None)
        state = saver() if saver is not None else self._inner.release()
        _pop(self.name)
        return state

    def _acquire_restore(self, state) -> None:
        restorer = getattr(self._inner, "_acquire_restore", None)
        if restorer is not None:
            restorer(state)
        else:
            self._inner.acquire()
        _push(self.name)

    def _is_owned(self) -> bool:
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        # plain Lock fallback: owned iff this thread holds it per our
        # own stack (mirrors threading.Condition's acquire(0) trick
        # without perturbing the lock)
        return any(n == self.name for n, _ in _held())

    def __repr__(self) -> str:
        return f"<sanitized {self._inner!r} name={self.name!r}>"


def make_lock(name: str):
    """A ``threading.Lock``, instrumented under ``REPRO_SANITIZE=1``."""
    if not enabled():
        return threading.Lock()
    return _TrackedLock(name, threading.Lock())


def make_rlock(name: str):
    """A ``threading.RLock``, instrumented under ``REPRO_SANITIZE=1``."""
    if not enabled():
        return threading.RLock()
    return _TrackedLock(name, threading.RLock())


def make_condition(name: str, lock=None):
    """A ``threading.Condition``.

    ``lock=None`` builds over a fresh RLock (the ``Scheduler.cv``
    shape); passing a ``make_lock`` result shares that lock's identity
    (the ``FleetRouter._cv`` - over - ``_lock`` shape), matching how
    the static pass aliases ``Condition(self._lock)`` to the lock's
    node.
    """
    if lock is None:
        lock = make_rlock(name) if enabled() else threading.RLock()
    return threading.Condition(lock)
