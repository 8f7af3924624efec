"""The port's ``ServeMetrics`` against ``repro``'s: fed the same
observations, both give the same ``to_dict`` (keys and values) and the
same ``summary``; ``from_dict`` inverts ``to_dict``; ``merge`` folds
snapshots of either package into one, with counts summed and
observation lists concatenated.  Everything here is exact: the metrics
hold Python numbers.
"""
import pickle

import pytest

from repro.serving import metrics as jmetrics
from repro_torch.serving import metrics as tmetrics


def feed(m, k=0):
    """One engine's worth of observations, varied by ``k``."""
    m.observe_compile(hit=False)
    m.observe_compile(hit=True)
    m.observe_queue_depth(3 + k)
    m.observe_state_bytes(4096 + k, shape_key="lat8x8x4/crf16x64")
    m.observe_state_bytes(1024, shape_key="lat4x4x4/crf4x64")
    m.observe_compiled_signatures(5 + k)
    m.observe_shed_events(k)
    for w in (0.1, 0.2, 0.3 + k, 1.0):
        m.observe_batch(4, 2, w, n_forwards=6, n_steps=20,
                        lane_full=[6, 4 + k], group_key=("adaptive", k),
                        lane_errors=[0.05, 0.07], lane_events=[1, 2],
                        shape_key="lat8x8x4/crf16x64")
    m.observe_batch(1, 1, 0.5, n_forwards=20, n_steps=20, lane_full=[20],
                    group_key=None, shape_key="lat4x4x4/crf4x64")
    for i in range(5):
        m.observe_request(0.01 * i, 0.4 + i, n_full=6 + i,
                          realized_error=0.01 * i if i % 2 else None,
                          budget_events=i if i % 2 else None)
    m.observe_first_result(1.5 + k)
    m.observe_first_result(9.0)            # later calls are no-ops
    m.observe_duplicate_result()
    m.observe_stale_pong_kill()
    return m


def test_to_dict_and_summary_equal_reference():
    got = feed(tmetrics.ServeMetrics())
    want = feed(jmetrics.ServeMetrics())
    assert got.to_dict() == want.to_dict()
    assert list(got.to_dict()) == list(want.to_dict())
    assert got.summary() == want.summary()
    assert got.n_requests == want.n_requests == 5
    assert got.full_step_fraction() == want.full_step_fraction()
    assert tmetrics.throughput(got, 2.0) == jmetrics.throughput(want, 2.0)
    assert tmetrics.throughput(got, 0.0) is None
    assert tmetrics.percentile([], 50) == 0.0
    for q in (0, 50, 95, 100):
        xs = [0.3, 0.1, 0.9, 0.2]
        assert tmetrics.percentile(xs, q) == jmetrics.percentile(xs, q)


def test_from_dict_is_the_inverse_and_the_wire_is_plain():
    m = feed(tmetrics.ServeMetrics(), k=1)
    d = m.to_dict()
    assert tmetrics.ServeMetrics.from_dict(d).to_dict() == d
    assert pickle.loads(pickle.dumps(d)) == d
    # a snapshot of the other package loads too, and a sparse one
    # (older schema) takes defaults
    assert tmetrics.ServeMetrics.from_dict(
        feed(jmetrics.ServeMetrics(), k=1).to_dict()).to_dict() == d
    old = tmetrics.ServeMetrics.from_dict({"compile_hits": 2})
    assert old.compile_hits == 2 and old.batch_walls == []
    assert old.shape_batches == {}


def test_snapshot_is_independent():
    m = feed(tmetrics.ServeMetrics())
    snap = m.snapshot()
    m.observe_request(0.0, 1.0, n_full=1, realized_error=0.5)
    assert snap.n_requests == 5 and m.n_requests == 6
    assert snap.summary()["realized_error_p95"] != \
        m.summary()["realized_error_p95"]


@pytest.mark.parametrize("order", ["port-first", "reference-first"])
def test_merge_across_packages(order):
    a = feed(tmetrics.ServeMetrics(), k=0)
    b = feed(jmetrics.ServeMetrics(), k=2)
    parts = [a, b.to_dict()] if order == "port-first" else [b.to_dict(), a]
    merged = tmetrics.ServeMetrics.merge(parts)
    want = jmetrics.ServeMetrics.merge(
        [jmetrics.ServeMetrics.from_dict(a.to_dict()).to_dict(),
         b.to_dict()] if order == "port-first"
        else [b.to_dict(), a.to_dict()])
    assert merged.to_dict() == want.to_dict()
    assert merged.summary() == want.summary()
    assert merged.compile_hits == a.compile_hits + b.compile_hits
    assert merged.n_requests == a.n_requests + b.n_requests
    assert merged.budget_events_total == 2 * a.budget_events_total
    assert merged.time_to_first_result_s == 1.5
    assert merged.compiled_signatures == 5 + 7
    assert merged.group_batches[str(("adaptive", 2))][0] == 4
    # associative: pairwise merges give the same snapshot
    c = feed(tmetrics.ServeMetrics(), k=1)
    left = tmetrics.ServeMetrics.merge(
        [tmetrics.ServeMetrics.merge([a, b.to_dict()]), c])
    right = tmetrics.ServeMetrics.merge(
        [a, tmetrics.ServeMetrics.merge([b.to_dict(), c])])
    assert left.to_dict() == right.to_dict()
