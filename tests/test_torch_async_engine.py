"""The port's ``AsyncDiffusionEngine`` and the engine's warmup and
signature accounting, on the CPU at dit-small width: the async scenarios
of ``tests/test_serving.py`` (future returned at once, many client
threads, a deadline-lapsed request served first, a client cancel, a
shutdown without drain), a batch that raises, and
``warmup(policies=, lane_policy_sets=, shapes=)`` against
``signature_budget``.

Latents served through the async path equal the sync engine's bit for
bit (the same eager computation on the same inputs).
"""
import math
import sys
import threading

import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.core import policies as tpol
from repro_torch.models import dit as tdit
from repro_torch.serving.async_engine import (AsyncDiffusionEngine,
                                              CancelledError)
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest

SIZE = 8
N_STEPS = 6


@pytest.fixture(scope="module")
def fns():
    cfg = tconfigs.reduced(tconfigs.get_config("dit-small"))
    params = tdit.init_params(cfg, seed=0, device="cpu")

    def full_fn(x, t):
        out = tdit.dit_forward(params, x, t.expand(x.shape[0]), cfg)
        return out.velocity, out.crf

    def from_crf_fn(crf, t):
        side = math.isqrt(crf.shape[1]) * cfg.patch_size
        return tdit.dit_from_crf(params, crf, t.expand(crf.shape[0]), cfg,
                                 side, side)
    return cfg, full_fn, from_crf_fn


def make_engine(fns, max_batch=4, policy=None, **kw):
    cfg, full_fn, from_crf_fn = fns
    return DiffusionEngine(full_fn, from_crf_fn,
                           (SIZE, SIZE, cfg.in_channels), (16, cfg.d_model),
                           policy or tpol.FreqCaPolicy(interval=3),
                           n_steps=N_STEPS, max_batch=max_batch,
                           device="cpu", **kw)


# ---------------------------------------------------------------------------
# warmup and signature accounting
# ---------------------------------------------------------------------------

def test_warmup_counts_signatures_within_budget(fns):
    """Every warmed (shape, signature, bucket) triple is one miss; the
    count stays within shapes x groups x buckets, and serving the warmed
    signatures afterwards adds only hits."""
    cfg = fns[0]
    eng = make_engine(fns, max_batch=2, group_policies=False)
    fora = tpol.ForaPolicy(interval=2)
    eb = tpol.FreqCaErrorBudgetPolicy(method="dct", rho=0.25, budget=0.2)
    second = ((SIZE * 2, SIZE * 2, cfg.in_channels), (64, cfg.d_model))
    eng.warmup(policies=[fora, eb], lane_policy_sets=[(eng.policy, eb)],
               shapes=[second])
    # per shape: default x 2 buckets, fora x 2, eb x 2, one mixed pair
    assert eng.compiled_buckets() == 2 * (3 * 2 + 1)
    assert eng.compiled_buckets() <= eng.signature_budget(n_groups=4)
    assert eng.metrics.compile_misses == eng.compiled_buckets()
    assert eng.metrics.compile_hits == 0
    s = eng.metrics.summary()
    assert s["compiled_signatures"] == eng.compiled_buckets()
    assert s["cache_state_bytes_per_lane"] == eng.state_bytes(
        1, *second)
    misses = eng.metrics.compile_misses
    for i, pol in enumerate((None, eb)):
        eng.submit(DiffusionRequest(request_id=i, seed=i, policy=pol))
    (a, b) = eng.run_batch()            # the warmed mixed pair
    assert a.bucket == 2 and b.realized_error is not None
    assert eng.metrics.compile_misses == misses
    assert eng.metrics.compile_hits == 1
    assert eng.metrics_dict()["compiled_signatures"] == misses
    with pytest.raises(ValueError, match="matches no bucket"):
        eng.warmup(buckets=[1], lane_policy_sets=[(fora, eb, fora)])


def test_execute_alias_and_normalized_signature(fns):
    eng = make_engine(fns, max_batch=2)
    assert DiffusionEngine._execute is DiffusionEngine.execute_plan
    pol = tpol.ForaPolicy(interval=2)
    assert eng._normalize_signature([pol, pol]) == pol
    assert eng._normalize_signature([pol, eng.policy]) == (pol, eng.policy)


# ---------------------------------------------------------------------------
# the async engine (tests/test_serving.py's scenarios)
# ---------------------------------------------------------------------------

def test_async_submit_returns_future_immediately(fns):
    eng = make_engine(fns, max_batch=2, max_wait_s=0.0)
    eng.warmup()
    with AsyncDiffusionEngine(eng) as aeng:
        fut = aeng.submit(DiffusionRequest(request_id=7, seed=7))
        res = fut.result(timeout=60)
        assert res.request_id == 7
        assert torch.isfinite(res.latents).all()
        assert fut.done()
        assert aeng.metrics_dict()["request_latencies"]
    with pytest.raises(RuntimeError):
        aeng.submit(DiffusionRequest(request_id=8, seed=8))
    sync = make_engine(fns, max_batch=2)
    (want,) = sync.run_batch([DiffusionRequest(request_id=7, seed=7)])
    assert torch.equal(res.latents, want.latents)
    assert eng.metrics.summary()["time_to_first_result_s"] is not None


def test_async_stress_many_client_threads(fns):
    """More client threads than cores, with a short switch interval:
    every future resolves exactly once, ids are conserved, nothing is
    lost or served twice."""
    eng = make_engine(fns, max_batch=4, max_wait_s=0.005)
    eng.warmup()
    n_threads, per_thread = 8, 3
    results, lock, futures = [], threading.Lock(), []

    def on_done(f):
        with lock:
            results.append(f.result(timeout=0))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AsyncDiffusionEngine(eng) as aeng:
            def client(k):
                futs = []
                for i in range(per_thread):
                    rid = k * per_thread + i
                    fut = aeng.submit(DiffusionRequest(request_id=rid,
                                                       seed=rid))
                    fut.add_done_callback(on_done)
                    futs.append(fut)
                with lock:
                    futures.extend(futs)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert aeng.drain(timeout=120)
            assert aeng.pending() == 0
    finally:
        sys.setswitchinterval(interval)
    total = n_threads * per_thread
    assert len(futures) == total and all(f.done() for f in futures)
    assert sorted(f.result(timeout=0).request_id for f in futures) == \
        list(range(total))
    assert sorted(r.request_id for r in results) == list(range(total))
    assert eng.scheduler.depth == 0
    assert eng.metrics.summary()["requests"] == total


def test_async_pending_excludes_resolved_inflight(fns):
    """``pending`` read as a future resolves, before the worker clears
    its in-flight map (as a client reading it right after ``drain`` may
    be): the resolved request is not counted."""
    eng = make_engine(fns, max_batch=2, max_wait_s=0.0)
    eng.warmup()
    seen = []
    with AsyncDiffusionEngine(eng) as aeng:
        fut = aeng.submit(DiffusionRequest(request_id=3, seed=3))
        fut.add_done_callback(lambda f: seen.append(aeng.pending()))
        assert aeng.drain(timeout=60)
        assert aeng.pending() == 0
    assert seen == [0]


def test_async_deadline_lapsed_served_first(fns):
    """Five requests queue before any cut, more than max_batch: the
    first cut promotes the deadline-lapsed last one ahead of three
    earlier undeadlined ones, and the one left over waits under the long
    age threshold until the drain."""
    eng = make_engine(fns, max_batch=2, max_wait_s=30.0)
    eng.warmup()
    aeng = AsyncDiffusionEngine(eng).start()
    try:
        with aeng.scheduler.cv:     # all five queued before any cut
            fa = aeng.submit(DiffusionRequest(request_id=10, seed=10))
            fb = aeng.submit(DiffusionRequest(request_id=11, seed=11))
            f2 = aeng.submit(DiffusionRequest(request_id=2, seed=2))
            f3 = aeng.submit(DiffusionRequest(request_id=3, seed=3))
            f4 = aeng.submit(DiffusionRequest(request_id=4, seed=4,
                                              deadline_s=0.0))
        assert f4.result(timeout=60).request_id == 4
        assert f2.result(timeout=60).request_id == 2
        assert fa.result(timeout=60).request_id == 10
        assert fb.result(timeout=60).request_id == 11
        assert not f3.done()
    finally:
        aeng.shutdown(drain=True, timeout=120)
    assert f3.result(timeout=0).request_id == 3


def test_async_client_cancel_does_not_kill_worker(fns):
    eng = make_engine(fns, max_batch=2, max_wait_s=0.0)
    eng.warmup()
    with AsyncDiffusionEngine(eng) as aeng:
        f0 = aeng.submit(DiffusionRequest(request_id=0, seed=0))
        f1 = aeng.submit(DiffusionRequest(request_id=1, seed=1))
        f2 = aeng.submit(DiffusionRequest(request_id=2, seed=2))
        cancelled = f2.cancel()    # races the cut: either way is legal
        f3 = aeng.submit(DiffusionRequest(request_id=3, seed=3))
        assert f3.result(timeout=60).request_id == 3
        assert f0.result(timeout=60).request_id == 0
        assert f1.result(timeout=60).request_id == 1
        if cancelled:
            assert f2.cancelled()
        else:
            assert f2.result(timeout=60).request_id == 2
    eng2 = make_engine(fns, max_batch=2, max_wait_s=30.0)
    aeng2 = AsyncDiffusionEngine(eng2).start()
    try:
        req = DiffusionRequest(request_id=0, seed=0)
        aeng2.submit(req)
        with pytest.raises(ValueError):
            aeng2.submit(req)
    finally:
        aeng2.shutdown(drain=True, timeout=120)


def test_async_shutdown_without_drain_cancels_queued(fns):
    eng = make_engine(fns, max_batch=2, max_wait_s=30.0)
    aeng = AsyncDiffusionEngine(eng).start()
    with aeng.scheduler.cv:         # queued, not yet cut (age 30 s)
        fut = aeng.submit(DiffusionRequest(request_id=0, seed=0))
    aeng.shutdown(drain=False, timeout=120)
    assert fut.cancelled()
    with pytest.raises(CancelledError):
        fut.result(timeout=0)
    assert eng.scheduler.depth == 0
    aeng.shutdown(drain=False, timeout=120)     # idempotent


def test_async_failed_batch_resolves_futures_and_keeps_serving(fns):
    """A batch that raises resolves each of its futures with that
    exception, once; the worker goes on serving the next batch."""
    cfg, full_fn, from_crf_fn = fns
    calls = {"n": 0}

    def flaky(x, t):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fault")
        return full_fn(x, t)
    eng = DiffusionEngine(flaky, from_crf_fn, (SIZE, SIZE, cfg.in_channels),
                          (16, cfg.d_model), tpol.FreqCaPolicy(interval=3),
                          n_steps=N_STEPS, max_batch=2, device="cpu")
    with AsyncDiffusionEngine(eng) as aeng:
        with aeng.scheduler.cv:
            bad = [aeng.submit(DiffusionRequest(request_id=i, seed=i))
                   for i in range(2)]
        for f in bad:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=60)
        good = aeng.submit(DiffusionRequest(request_id=5, seed=5))
        assert good.result(timeout=60).request_id == 5
    assert eng.metrics.duplicate_results == 0
