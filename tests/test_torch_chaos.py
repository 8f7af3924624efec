"""The port's self-healing fleet under deterministic faults, on the
scenarios of ``tests/test_chaos.py``.

Unit tier (no engine is built): supervisor backoff and
``can_recover``; ``FaultInjector.spec_for`` equal to the reference's
for the same seed; the router's quarantine / isolation-probe /
backpressure / shed logic on fake replicas; the worker coalescing
overlapping drains; boot failure, boot timeout and the kill latch (their
children die before they import torch) and a replica whose factory
needs a card that is not there.

Integration tier (real workers, each on one thread): a killed replica
restarted that serves a second wave, a hung worker killed once and
restarted, and a poison request quarantined while healthy traffic
completes.

Scenarios the reference writes against module globals are called from
that module with its classes swapped for the port's; the engine factory
is ``test_torch_fleet.tiny_engine`` (a spawned worker imports that
file, which imports neither ``repro`` nor JAX).
"""
import functools
import pickle
import threading
import time

import pytest
import torch

from repro_torch.serving.engine import DiffusionRequest
from repro_torch.serving.fleet import (FaultInjector, FleetMetrics,
                                       FleetSupervisor, PoisonRequestError,
                                       Replica)
from repro_torch.serving.fleet.worker import worker_main
from repro_torch.serving.metrics import ServeMetrics
from test_torch_fleet import PinnedRouter, tiny_engine


@pytest.fixture
def ref(monkeypatch):
    import test_chaos
    for name, obj in [("FleetRouter", PinnedRouter),
                      ("FleetSupervisor", FleetSupervisor),
                      ("FaultInjector", FaultInjector),
                      ("PoisonRequestError", PoisonRequestError),
                      ("Replica", Replica), ("worker_main", worker_main),
                      ("ServeMetrics", ServeMetrics),
                      ("DiffusionRequest", DiffusionRequest),
                      ("tiny_engine", tiny_engine)]:
        monkeypatch.setattr(test_chaos, name, obj)
    return test_chaos


# ---------------------------------------------------------------------------
# supervisor policy, fault specs, wire format (unit)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", [
    "test_backoff_exponential_and_capped",
    "test_can_recover_tracks_retired_slots",
    "test_fault_specs_are_scoped_and_deterministic",
    "test_fault_later_rules_win",
    "test_stale_pong_kills_on_the_wire",
    "test_wire_format_tolerates_older_schema",
])
def test_unit_scenario(ref, scenario):
    getattr(ref, scenario)()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_specs_equal_reference(seed):
    from repro.serving.fleet import FaultInjector as JaxFaultInjector

    def plan(cls):
        return (cls(seed=seed)
                .kill_after_submits(2, slot=0, start_n=0)
                .fail_boot(slot=0, start_n=1)
                .hang_boot(3.0, slot=1)
                .kill_on_request(99)
                .mute_pings_after(3, start_n=2)
                .delay_results(0.1, jitter_s=0.05, slot=1)
                .delay_results(0.2, jitter_s=0.5, slot=2, start_n=1))
    got, want = plan(FaultInjector), plan(JaxFaultInjector)
    for slot in range(4):
        for start_n in range(4):
            assert got.spec_for(slot, start_n) == \
                want.spec_for(slot, start_n), (slot, start_n)


def test_fleet_metrics_fold_router_snap():
    fm = FleetMetrics({0: ServeMetrics().to_dict()},
                      router_snap={"stale_pong_kills": 2,
                                   "duplicate_results": 1})
    merged = fm.merged()
    assert merged.stale_pong_kills == 2
    assert merged.duplicate_results == 1


def test_launcher_robustness_flags():
    from repro_torch.launch.serve import build_parser
    args = build_parser().parse_args([])
    assert args.max_restarts == 2 and args.max_inflight == 0
    args = build_parser().parse_args(
        ["--max-restarts", "0", "--max-inflight", "8"])
    assert args.max_restarts == 0 and args.max_inflight == 8


# ---------------------------------------------------------------------------
# quarantine / probe / backpressure logic on fake replicas (unit)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", [
    "test_solo_death_at_budget_is_quarantined",
    "test_cohort_death_probes_instead_of_quarantining",
    "test_probation_replica_excluded_from_routing",
    "test_backpressure_blocks_until_capacity_frees",
    "test_backpressure_sheds_quality_once",
])
def test_router_scenario(ref, scenario):
    getattr(ref, scenario)()


# ---------------------------------------------------------------------------
# worker drain-thread dedupe — worker_main run in a thread
# ---------------------------------------------------------------------------

def test_worker_coalesces_overlapping_drains(ref, monkeypatch):
    """The reference's scenario on the port's ``worker_main``, whose
    async engine (imported lazily from the port) is the reference
    test's slow-draining stand-in."""
    import multiprocessing as mp

    import repro_torch.serving.async_engine as ae
    slow = ref._SlowDrainAsync
    monkeypatch.setattr(ae, "AsyncDiffusionEngine", slow)
    slow.drains = 0
    parent, child = mp.Pipe()
    payload = pickle.dumps((ref._fake_serve_engine, {}))
    th = threading.Thread(target=worker_main,
                          args=(child, {}, payload, None), daemon=True)
    th.start()
    try:
        assert parent.poll(10.0)
        assert parent.recv()[0] == "ready"
        for _ in range(5):
            parent.send(("drain",))
            time.sleep(0.05)
        flushers = [t for t in threading.enumerate()
                    if t.name == "fleet-worker-drain" and t.is_alive()]
        assert len(flushers) == 1, flushers
        assert parent.poll(10.0)
        assert parent.recv() == ("drained",)
        assert slow.drains == 1   # 5 commands, one flush
    finally:
        parent.send(("stop",))
        th.join(10.0)
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# boot failures (cheap children) and the no-card factory
# ---------------------------------------------------------------------------

def test_boot_failures_are_killed_joined_and_closed(ref):
    """The reference's boot-error, boot-timeout and kill-latch
    scenarios (their workers die before unpickling the factory), then a
    replica whose engine factory resolves the card in the child with no
    card present: a boot failure the router raises, never a CPU
    engine."""
    ref.test_boot_error_is_killed_joined_and_closed()
    ref.test_boot_timeout_is_killed_joined_and_closed()
    ref.test_replica_kill_is_latched()
    if torch.cuda.is_available():
        return
    import numpy as np

    import repro_torch.configs as config_lib
    from repro_torch.checkpointing import bridge
    from repro_torch.launch.serve import fleet_engine_factory
    from repro_torch.models import dit
    cfg = config_lib.reduced(config_lib.get_config("dit-small"))
    wire = bridge.params_to_wire(dit.init_params(cfg, device="cpu"), cfg)
    assert all(isinstance(a, np.ndarray) for a in _leaves(wire))
    factory = functools.partial(fleet_engine_factory, wire, cfg, 8, 4, 2,
                                0.05, "dct", 3, None, True, None, 4.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory()                                   # in this process
    router = PinnedRouter(factory, n_replicas=1)
    with pytest.raises(RuntimeError, match="(?s)failed to boot.*no CUDA"):
        router.start()
    (r,) = router.replicas
    assert not r.proc.is_alive() and r.conn.closed


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# integration: real workers under injected faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", [
    "test_killed_replica_restarts_and_serves_post_rejoin",
    "test_hung_worker_killed_once_and_restarted",
    "test_poison_is_quarantined_healthy_traffic_unaffected",
])
def test_integration_scenario(ref, scenario):
    getattr(ref, scenario)()
