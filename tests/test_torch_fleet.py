"""The port's fleet (``repro_torch.serving.fleet``) on the scenarios of
``tests/test_fleet.py``: the metrics' wire format and merge,
``FleetMetrics.summary`` equal to the reference's on the same
per-replica snapshots, bad-config rejection, the exactly-once guards on
fake replicas, two real replica processes end to end against the
in-process engine, and a SIGKILLed replica's work requeued onto the
survivor.

Scenarios the reference writes against module globals are called from
that module with its classes swapped for the port's (as
``test_torch_scheduler_properties.py`` does); the reference module is
imported inside the fixture, so a spawned worker that imports this file
for ``tiny_engine`` imports neither ``repro`` nor JAX.

Every router here passes ``PINNED_ENV``: each child computes on one
thread, since the suite runs several test workers at once.  On the CPU
a lane served in a batch of 1 and in a batch of 4 differs in the last
bits (the GEMMs sum in another order), so a fleet result is bitwise
equal to the in-process engine's where its bucket is the same, and
within ``REL_TOL`` of the largest latent where it is not.
``tiny_engine`` must stay module-level: the spawn start method pickles
the factory by reference and re-imports this module in the child.
"""
import numpy as np
import pytest
import torch

from repro_torch.serving.engine import DiffusionRequest
from repro_torch.serving.fleet import FleetMetrics, FleetRouter
from repro_torch.serving.metrics import ServeMetrics

SIZE = 8
N_STEPS = 6
MAX_BATCH = 4
PINNED_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
REL_TOL = 1e-5
# every wait of a spawning test is bounded: boot, drain and each result
SPAWN_TIMEOUT_S = 120


def tiny_engine():
    """Zero-arg picklable factory: a reduced dit-small engine on the CPU,
    built fresh in whichever process calls it (parameters from seed 0,
    every leaf perturbed so each block contributes; replicas and
    incarnations are identical)."""
    import repro_torch.configs as config_lib
    from repro_torch.core.cache import CachePolicy
    from repro_torch.launch.serve import dit_fns
    from repro_torch.models import dit
    from repro_torch.serving.engine import DiffusionEngine

    cfg = config_lib.reduced(config_lib.get_config("dit-small"))
    params = dit.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    stack = [params]
    while stack:
        node = stack.pop()
        items = node.values() if isinstance(node, dict) else node
        for v in items:
            if isinstance(v, torch.Tensor):
                v.add_(0.02 * torch.randn(v.shape, generator=gen))
            else:
                stack.append(v)
    full_fn, from_crf_fn = dit_fns(params, cfg)
    return DiffusionEngine(full_fn, from_crf_fn,
                           (SIZE, SIZE, cfg.in_channels),
                           (16, cfg.d_model),
                           CachePolicy(kind="freqca", interval=3),
                           n_steps=N_STEPS, max_batch=MAX_BATCH,
                           max_wait_s=0.05, device="cpu")


class PinnedRouter(FleetRouter):
    """``FleetRouter`` whose workers default to one compute thread and
    whose boot wait is bounded by ``SPAWN_TIMEOUT_S``."""

    def __init__(self, factory, n_replicas: int = 2, **kw):
        kw.setdefault("worker_env", PINNED_ENV)
        kw.setdefault("boot_timeout_s", SPAWN_TIMEOUT_S)
        super().__init__(factory, n_replicas, **kw)


def assert_matches_inprocess(outs, want):
    """Fleet results against the in-process engine's, per request:
    ``n_full_steps`` exactly; latents bitwise at the same bucket, else
    within ``REL_TOL``."""
    for o in outs:
        w = want[o.request_id]
        assert o.n_full_steps == w.n_full_steps, o.request_id
        assert isinstance(o.latents, np.ndarray)     # host-side on the wire
        got = torch.from_numpy(o.latents)
        if o.bucket == w.bucket:
            assert torch.equal(got, w.latents), \
                f"request {o.request_id} diverged at bucket {o.bucket}"
        else:
            torch.testing.assert_close(
                got, w.latents, rtol=0,
                atol=REL_TOL * float(w.latents.abs().max()))


def _requests(n, start=0):
    return [DiffusionRequest(request_id=start + i, seed=start + i)
            for i in range(n)]


@pytest.fixture
def ref(monkeypatch):
    import test_fleet
    monkeypatch.setattr(test_fleet, "ServeMetrics", ServeMetrics)
    monkeypatch.setattr(test_fleet, "FleetMetrics", FleetMetrics)
    monkeypatch.setattr(test_fleet, "FleetRouter", PinnedRouter)
    monkeypatch.setattr(test_fleet, "DiffusionRequest", DiffusionRequest)
    monkeypatch.setattr(test_fleet, "tiny_engine", tiny_engine)
    return test_fleet


# ---------------------------------------------------------------------------
# metrics wire format and fleet aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", [
    "test_metrics_dict_roundtrip",
    "test_metrics_merge_is_lossless_and_associative",
    "test_fleet_metrics_summary_sections",
])
def test_metrics_scenario(ref, scenario):
    getattr(ref, scenario)()


def test_fleet_metrics_summary_equals_reference(ref):
    """The same per-replica snapshots (written by the reference's
    ``ServeMetrics``), routing counters, boot metadata and router
    counters give the reference's summary, section by section."""
    import repro.serving.fleet as jfleet
    import repro.serving.metrics as jmetrics
    ref.ServeMetrics = jmetrics.ServeMetrics
    snaps = {i: ref._sample_metrics(seed=i).to_dict() for i in range(3)}
    ref.ServeMetrics = ServeMetrics
    assert {i: ref._sample_metrics(seed=i).to_dict()
            for i in range(3)} == snaps               # one wire format
    kw = dict(routing={"affinity_hits": 5, "spills": 1, "requeued": 2},
              meta={0: {"warmup_compiles": 1}, 1: {"warmup_compiles": 0},
                    2: {}},
              router_snap={"duplicate_results": 1, "stale_pong_kills": 2})
    got = FleetMetrics(snaps, **kw)
    want = jfleet.FleetMetrics(snaps, **kw)
    assert got.summary() == want.summary()
    assert got.merged().to_dict() == want.merged().to_dict()
    assert [got.steady_recompiles(i) for i in range(4)] == \
        [want.steady_recompiles(i) for i in range(4)] == [0, 1, None, None]


def test_replicas_flag_defaults_to_inprocess():
    from repro_torch.launch.serve import build_parser
    args = build_parser().parse_args([])
    assert args.replicas == 1          # default: in-process engine path
    args = build_parser().parse_args(["--replicas", "2"])
    assert args.replicas == 2


# ---------------------------------------------------------------------------
# router: config checks and the exactly-once guards on fake replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", [
    "test_router_rejects_bad_config",
    "test_double_set_result_absorbed_by_duplicate_counter",
    "test_finish_is_idempotent_per_token",
])
def test_router_scenario(ref, scenario):
    getattr(ref, scenario)()


def test_async_engine_absorbs_duplicate_resolution():
    """The port's async worker uses the same exactly-once guard: a
    future that resolved early degrades to ``duplicate_results``."""
    from concurrent.futures import Future

    from repro_torch.serving.async_engine import AsyncDiffusionEngine

    class _Eng:
        def __init__(self):
            self.metrics = ServeMetrics()

        def execute_plan(self, plan):
            return ["res"]

    aeng = AsyncDiffusionEngine.__new__(AsyncDiffusionEngine)
    aeng.engine = _Eng()
    aeng.metrics = aeng.engine.metrics
    aeng._t0 = None
    fut = Future()
    # repro: allow[future-guard]: seeding the double resolution this test exists to exercise
    fut.set_result("early")
    aeng._serve(plan=None, futs=[fut])  # must not raise
    assert fut.result() == "early"
    assert aeng.metrics.to_dict()["duplicate_results"] == 1


def test_wire_request_is_host_numpy():
    """``init_latents`` crosses the pipe as a numpy array, never as a
    tensor (torch's reducers would share it, or re-land it on a card)."""
    from repro_torch.serving.fleet.router import _wire_request
    req = DiffusionRequest(request_id=0, seed=0)
    assert _wire_request(req) is req
    lat = torch.randn(SIZE, SIZE, 4)
    wired = _wire_request(DiffusionRequest(request_id=1, seed=1,
                                           init_latents=lat))
    assert isinstance(wired.init_latents, np.ndarray)
    np.testing.assert_array_equal(wired.init_latents, lat.numpy())


# ---------------------------------------------------------------------------
# end to end: real worker processes
# ---------------------------------------------------------------------------

def test_fleet_two_replicas_end_to_end():
    n = 10
    router = PinnedRouter(tiny_engine, n_replicas=2)
    try:
        router.start()
        assert all(r.healthy for r in router.replicas)
        assert router.spill_slack == MAX_BATCH   # from ready metadata
        assert all(r.boot_s > 0 for r in router.replicas)
        futs = [router.submit(r) for r in _requests(n)]
        assert router.drain(timeout=SPAWN_TIMEOUT_S)
        outs = [f.result(timeout=10.0) for f in futs]
        fm = router.fleet_metrics()
    finally:
        router.shutdown(drain=False)

    assert sorted(o.request_id for o in outs) == list(range(n))
    eng = tiny_engine()
    eng.warmup()
    for r in _requests(n):
        eng.submit(r)
    assert_matches_inprocess(
        outs, {o.request_id: o for o in eng.serve_until_drained()})

    s = fm.summary()
    assert s["fleet"]["requests"] == n
    assert s["fleet"]["replicas"] == 2
    for idx, pr in s["per_replica"].items():
        assert pr["steady_recompiles"] == 0, (idx, pr)
    rt = s["routing"]
    assert rt["submitted"] == rt["resolved"] == n
    assert rt["failed"] == 0 and rt["duplicate_results"] == 0
    assert rt["requeued"] == 0 and rt["replicas_lost"] == 0
    assert rt["new_groups"] >= 1
    assert rt["new_groups"] + rt["affinity_hits"] + rt["spills"] == n


def test_replica_crash_requeues_onto_survivor(ref):
    ref.test_replica_crash_requeues_onto_survivor()
