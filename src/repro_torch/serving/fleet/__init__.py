"""Multi-process serving fleet: N engine replicas behind a router (the
port's counterpart of ``repro.serving.fleet``).

The single-process stack (scheduler -> engine -> async engine) scales
to one hot process; this package is the next tier.  ``worker`` runs one
``DiffusionEngine`` + ``AsyncDiffusionEngine`` per child process behind
a stdlib ``multiprocessing.connection`` command/response channel;
``router.FleetRouter`` is the frontend that admits
``DiffusionRequest``s, routes them by policy-compatibility affinity
plus replica load (so policy-pure batches keep forming fleet-wide),
health-checks the replicas, requeues in-flight work off a dead one,
and drains/shuts down with the same semantics as
``AsyncDiffusionEngine``; ``fleet_metrics.FleetMetrics`` aggregates
per-replica ``ServeMetrics`` snapshots into fleet-wide percentiles and
per-replica/routing breakdowns.

The fleet is self-healing: ``supervisor.FleetSupervisor`` restarts
dead replicas with capped exponential backoff and retires
crash-loopers; the router bounds per-replica in-flight work
(backpressure with optional quality shedding), gives each request a
retry budget, and quarantines poison requests (``PoisonRequestError``)
after a solo kill or a failed isolation probe.  ``faults.FaultInjector``
is the deterministic chaos layer that exercises all of this in the
chaos tests.

Replicas share the parent's card unless ``worker_env`` says otherwise;
each child process holds its own CUDA context and its own copy of the
weights, which cross the pipe as a numpy tree
(``repro_torch.launch.serve.fleet_engine_factory``).
"""
from repro_torch.serving.fleet.faults import FaultInjector  # noqa: F401
from repro_torch.serving.fleet.fleet_metrics import (  # noqa: F401
    FleetMetrics)
from repro_torch.serving.fleet.router import (  # noqa: F401
    FleetRouter, PoisonRequestError)
from repro_torch.serving.fleet.supervisor import (  # noqa: F401
    FleetSupervisor)
from repro_torch.serving.fleet.worker import Replica  # noqa: F401

__all__ = ["FaultInjector", "FleetMetrics", "FleetRouter",
           "FleetSupervisor", "PoisonRequestError", "Replica"]
