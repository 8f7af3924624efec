"""The port's lock-order sanitizer (``repro_torch.analysis.runtime``) on
the scenarios of ``tests/test_sanitizers.py``: plain primitives unless
``REPRO_SANITIZE=1``, a seeded inversion raising ``LockOrderError``
instead of deadlocking, consistent orders silent, reentrancy no edge,
``Condition`` semantics intact; the order graph equal to the reference
sanitizer's for the same acquisitions; and, with the flag set, the
port's ``Scheduler.cv``, ``ServeMetrics._lock`` and the fleet router's
locks instrumented.

The lock scenarios call their namesakes in that module with its ``rt``
swapped for the port's module; the scenarios themselves are shared,
unchanged.  The tracer-leak checks are JAX-only and have no counterpart.
"""
import random
import threading

import pytest

import test_sanitizers as ref
from repro.analysis import graphs as jgraphs
from repro.analysis import runtime as jrt
from repro_torch.analysis import graphs as tgraphs
from repro_torch.analysis import runtime as trt


@pytest.fixture
def port(monkeypatch):
    monkeypatch.setattr(ref, "rt", trt)


@pytest.fixture
def sanitized(port, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    trt.reset_order_graph()
    yield
    trt.reset_order_graph()


def test_factories_are_plain_when_disabled(port, monkeypatch):
    ref.test_factories_are_plain_when_disabled(monkeypatch)
    assert isinstance(trt.make_rlock("x"), type(threading.RLock()))


def test_enabled_reads_env_at_call_time(port, monkeypatch):
    ref.test_enabled_reads_env_at_call_time(monkeypatch)


@pytest.mark.parametrize("scenario", [
    "test_seeded_inversion_raises_not_deadlocks",
    "test_consistent_order_is_silent",
    "test_inversion_detected_across_threads",
    "test_rlock_reentrancy_is_not_an_edge",
    "test_condition_wait_notify_through_sanitized_lock",
    "test_condition_over_shared_lock_is_one_node",
])
def test_lock_scenario(sanitized, scenario):
    getattr(ref, scenario)(None)


def _acquisitions(rt):
    """One script of nested acquisitions over both lock kinds and a
    condition sharing a lock; returns the observed order graph."""
    a, b, c = rt.make_lock("A"), rt.make_rlock("B"), rt.make_lock("C")
    cv = rt.make_condition("CV", lock=c)
    with a:
        with b:
            with b:
                with cv:
                    cv.notify_all()
    with b:
        with c:
            pass
    with a:
        with c:
            pass
    return rt.order_graph()


def test_order_graph_equals_reference(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    for rt in (jrt, trt):
        rt.reset_order_graph()
    try:
        got, want = _acquisitions(trt), _acquisitions(jrt)
        assert got == want == {"A": {"B", "C"}, "B": {"C"}}
        # the same inversion is refused by both
        for rt in (trt, jrt):
            c, a = rt.make_lock("C"), rt.make_lock("A")
            with c:
                with pytest.raises(rt.LockOrderError, match="inversion"):
                    a.acquire()
    finally:
        for rt in (jrt, trt):
            rt.reset_order_graph()


@pytest.mark.parametrize("seed", range(4))
def test_graph_helpers_equal_reference(seed):
    rng = random.Random(seed)
    nodes = list(range(8))
    graph = {n: {m for m in nodes if rng.random() < 0.2} for n in nodes}
    assert tgraphs.find_cycle(graph) == jgraphs.find_cycle(graph)
    for src in nodes:
        for dst in nodes:
            assert tgraphs.has_path(graph, src, dst) == \
                jgraphs.has_path(graph, src, dst)
            assert tgraphs.would_close_cycle(graph, src, dst) == \
                jgraphs.would_close_cycle(graph, src, dst)


def test_serving_locks_are_sanitized_under_flag(sanitized):
    from repro_torch.serving.fleet import FleetRouter
    from repro_torch.serving.metrics import ServeMetrics
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(max_batch=2)
    assert isinstance(sched.cv._lock, trt._TrackedLock)
    assert sched.cv._lock.name == "Scheduler.cv"
    with sched.cv:                   # still a working condition variable
        sched.cv.notify_all()
    m = ServeMetrics()
    assert isinstance(m._lock, trt._TrackedLock)
    assert m._lock.name == "ServeMetrics._lock"
    snap = m.snapshot()
    assert snap._lock is not m._lock
    assert isinstance(snap._lock, trt._TrackedLock)
    m.observe_compile(hit=False)      # records through the tracked lock
    assert m.to_dict()["compile_misses"] == 1
    router = FleetRouter(lambda: None, n_replicas=1)   # never started
    assert isinstance(router._lock, trt._TrackedLock)
    assert router._cv._lock is router._lock          # one node
    assert router._lock.name == "FleetRouter._lock"


def test_serving_locks_are_plain_without_flag(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    from repro_torch.serving.metrics import ServeMetrics
    from repro_torch.serving.scheduler import Scheduler
    assert isinstance(Scheduler(max_batch=2).cv._lock,
                      type(threading.RLock()))
    assert isinstance(ServeMetrics()._lock, type(threading.Lock()))
