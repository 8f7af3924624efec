"""The serving-invariant harness of ``tests/test_scheduler_properties.py``
run against the port's scheduler copy (``repro_torch.serving.scheduler``)
and the port's ``CachePolicy`` specs: conservation, stable FIFO within a
compatibility group, deadline promotion, policy and shape purity, and
bucketing, on hypothesis streams and on the deterministic twins.

Each test here calls its namesake in that module with the module's
``Scheduler``, ``DiffusionRequest``, bucket helpers and policy specs
swapped for the port's; the checker itself is shared, unchanged.
"""
import dataclasses

import pytest

import test_scheduler_properties as ref
from repro_torch.core.cache import CachePolicy
from repro_torch.serving import scheduler as tsched


@pytest.fixture
def port(monkeypatch):
    def spec(p):
        return None if p is None else CachePolicy(**dataclasses.asdict(p))
    monkeypatch.setattr(ref, "Scheduler", tsched.Scheduler)
    monkeypatch.setattr(ref, "DiffusionRequest", tsched.DiffusionRequest)
    monkeypatch.setattr(ref, "bucket_for", tsched.bucket_for)
    monkeypatch.setattr(ref, "bucket_sizes", tsched.bucket_sizes)
    monkeypatch.setattr(ref, "DEFAULT", spec(ref.DEFAULT))
    monkeypatch.setattr(ref, "POLICIES", [spec(p) for p in ref.POLICIES])


def test_invariants_hold_for_arbitrary_streams(port):
    ref.test_invariants_hold_for_arbitrary_streams()


def test_invariants_hold_with_pad_to_max(port):
    ref.test_invariants_hold_with_pad_to_max()


def test_grouped_and_ungrouped_serve_identical_request_sets(port):
    ref.test_grouped_and_ungrouped_serve_identical_request_sets()


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("max_batch", [1, 3, 4])
def test_deterministic_mixed_stream(port, grouped, max_batch):
    ref.test_deterministic_mixed_stream(grouped, max_batch)


def test_deterministic_pad_to_max(port):
    ref.test_deterministic_pad_to_max()


def test_deterministic_deadline_burst(port):
    ref.test_deterministic_deadline_burst()


def test_deterministic_rare_group_not_starved(port):
    ref.test_deterministic_rare_group_not_starved()


def test_deterministic_static_families_share_batches(port):
    ref.test_deterministic_static_families_share_batches()


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("max_batch", [1, 3, 4])
def test_deterministic_multishape_stream(port, grouped, max_batch):
    ref.test_deterministic_multishape_stream(grouped, max_batch)


@pytest.mark.parametrize("grouped", [False, True])
def test_deterministic_shape_purity_same_policy(port, grouped):
    ref.test_deterministic_shape_purity_same_policy(grouped)


def test_deterministic_no_cross_shape_promotion(port):
    ref.test_deterministic_no_cross_shape_promotion()


def test_deterministic_partial_shape_declaration(port):
    """The reference test imports its own ``Scheduler`` in its body, so
    it is restated here against the port's."""
    shapes = ref.SHAPES
    ladder = {shapes[1], shapes[2]}
    sched = tsched.Scheduler(max_batch=4, max_wait_s=0.0, clock=lambda: 0.0,
                             default_shape=shapes[1],
                             allowed_shapes=set(ladder))
    sched.submit(tsched.DiffusionRequest(request_id=0, seed=0,
                                         latent_shape=shapes[2][0]), now=0.0)
    sched.submit(tsched.DiffusionRequest(request_id=1, seed=1), now=0.0)
    plan = sched.form_batch(now=1.0)
    assert [r.request_id for r in plan.requests] == [0]
    assert plan.crf_shape == shapes[2][1]
    plan = sched.form_batch(now=1.0)
    assert [r.request_id for r in plan.requests] == [1]
    assert plan.latent_shape == shapes[1][0]
    with pytest.raises(tsched.ShapeMismatchError):
        sched.submit(tsched.DiffusionRequest(
            request_id=2, seed=2, latent_shape=shapes[3][0]), now=0.0)
