"""Serving launcher (counterpart of ``repro.launch.serve``): the paper's
deployment shape, continuous batching.

Trains the small DiT (``launch.train.train_dit``), warms one ladder of
(shape, signature, bucket) triples per engine, then serves a mixed-size
request stream (generation + editing) through the FreqCa-cached
``DiffusionEngine``.  Reports the scheduler/engine metrics (occupancy,
p50/p95 latency, full-step fraction, compile accounting), throughput,
speedup vs the uncached engine, and output fidelity (PSNR vs uncached).

"Compile" keeps the reference's names, but the port runs eagerly: a
warmup "compile" is the first run of a triple, and a steady-state
recompile a triple the warmup did not run (``serving/metrics.py``).

Three client shapes, as in the reference:

* closed loop (``--arrival burst``, default) — deterministic bursts,
  each drained before the next arrives;
* open loop (``--arrival poisson --rate R``) — requests arrive on a
  Poisson process at R req/s regardless of server progress, replayed by
  one thread interleaving submits with engine turns;
* threaded open loop (``--arrival poisson --clients N``) — the arrival
  plan is split over N client threads submitting concurrently through
  ``AsyncDiffusionEngine``.

``--mixed-policies`` cycles per-request cache policies (freqca / fora /
freqca_a); ``--ungrouped`` turns off policy-homogeneous batch formation.
``--replicas N`` (N > 1) serves the same stream through the
multi-process fleet (``serving/fleet``): N replica processes, each
shipped the trained parameters as a numpy tree, warm their own ladders
behind a ``FleetRouter``; ``--max-restarts`` and ``--max-inflight``
bound its supervision and queues.

Everything runs on the card unless ``--device cpu`` is given (the
tests); with no card and no ``--device cpu`` it raises.  Edit references
are drawn from ``torch.Generator().manual_seed(1000 + rid)``, so their
pixels differ from the reference's JAX draws; noise per request seed is
the engine's (``DiffusionEngine.build_x_init``).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 10 \\
      --steps 10 --train-steps 10 --batch 4            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --requests 4 --steps 4 --train-steps 2 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arrival poisson \\
      --rate 2 --clients 2
  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2
"""
from __future__ import annotations

import argparse
import functools
import itertools
import math
import threading
import time

import numpy as np
import torch

from repro_torch import configs as config_lib
from repro_torch import device as device_lib
from repro_torch.checkpointing import bridge
from repro_torch.configs.base import DiTConfig
from repro_torch.core import policies as policy_lib
from repro_torch.data import synthetic
from repro_torch.launch.train import train_dit
from repro_torch.models import dit
from repro_torch.serving.async_engine import AsyncDiffusionEngine
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
from repro_torch.serving.scheduler import bucket_for


def psnr(a, b, data_range=2.0):
    """PSNR (dB) of ``a`` against ``b`` (tensors or arrays, float32)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    mse = float(torch.mean(torch.square(a - b)))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def shape_ladder(cfg, sizes):
    """The (latent [H, W, C], CRF [S, D]) shape pair per image size:
    size ``s`` patchifies to ``(s / patch_size)^2`` tokens."""
    return [((s, s, cfg.in_channels),
             ((s // cfg.patch_size) ** 2, cfg.d_model)) for s in sizes]


def _make_request(rid: int, size: int, channels: int, edit_every: int,
                  policies=None, max_error=None,
                  shapes=None) -> DiffusionRequest:
    pol = policies[rid % len(policies)] if policies else None
    shape = shapes[rid % len(shapes)] if shapes else None
    lat = shape[0] if shape else None
    crf = shape[1] if shape else None
    if shape is not None:
        size = shape[0][0]    # edit refs must match the declared latent
    if edit_every and rid % edit_every == edit_every - 1:
        ref = synthetic.shapes_batch(
            torch.Generator().manual_seed(1000 + rid), 1, size=size,
            channels=channels, device="cpu")[0]
        return DiffusionRequest(request_id=rid, seed=rid, init_latents=ref,
                                edit_strength=0.5, policy=pol,
                                max_error=max_error,
                                latent_shape=lat, crf_shape=crf)
    return DiffusionRequest(request_id=rid, seed=rid, policy=pol,
                            max_error=max_error,
                            latent_shape=lat, crf_shape=crf)


def mixed_stream(n_requests: int, size: int, channels: int,
                 edit_every: int = 5, policies=None, max_error=None,
                 shapes=None):
    """Deterministic mixed request stream: bursts of varying size, every
    ``edit_every``-th request an editing request from a synthetic ref;
    optional per-request cache policies (and multi-resolution shape
    pairs) assigned round-robin."""
    reqs, rid = [], 0
    burst_sizes = itertools.cycle([1, 3, 8, 2, 4, 1])
    while rid < n_requests:
        burst = []
        for _ in range(min(next(burst_sizes), n_requests - rid)):
            burst.append(_make_request(rid, size, channels, edit_every,
                                       policies, max_error=max_error,
                                       shapes=shapes))
            rid += 1
        reqs.append(burst)
    return reqs


def poisson_stream(n_requests: int, rate: float, size: int, channels: int,
                   edit_every: int = 5, policies=None, seed: int = 0,
                   max_error=None, shapes=None):
    """Open-loop arrival plan: a flat list of ``DiffusionRequest`` with
    exponential inter-arrival times at ``rate`` req/s stamped into each
    request's ``arrival_s``, drawn from ``np.random.RandomState(seed)``
    as the reference draws them (the same times, bit for bit).
    ``shapes`` cycles multi-resolution shape pairs round-robin."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.RandomState(seed)
    t, plan = 0.0, []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        req = _make_request(rid, size, channels, edit_every, policies,
                            max_error=max_error, shapes=shapes)
        req.arrival_s = t
        plan.append(req)
    return plan


def serve_stream(eng: DiffusionEngine, bursts) -> tuple:
    """Replay bursts through the engine; each burst is drained before the
    next arrives (closed-loop client)."""
    outs = []
    t0 = time.perf_counter()
    for burst in bursts:
        for r in burst:
            eng.submit(r)
        outs.extend(eng.serve_until_drained())
    wall = time.perf_counter() - t0
    return outs, wall


def cyclic_signatures(policies, max_batch: int):
    """Every per-lane policy set an UNGROUPED FIFO batch former can cut
    from a round-robin assignment: windows of the policy cycle (any
    offset, any real-lane count), padded to their bucket with the
    window's first policy — the engine's padding rule.  Warming these
    makes ungrouped open-loop serving free of first runs wherever
    arrivals split the batches."""
    seen, sets = set(), []
    k = len(policies)
    for off in range(k):
        for n in range(1, max_batch + 1):
            lanes = [policies[(off + i) % k] for i in range(n)]
            lanes += [lanes[0]] * (bucket_for(n, max_batch) - n)
            key = tuple(lanes)
            if key not in seen:
                seen.add(key)
                sets.append(key)
    return sets


def serve_open_loop(eng: DiffusionEngine, plan, poll_s: float = 0.002):
    """Replay a timestamped arrival plan in real time (open-loop client):
    the queue grows while the engine is busy, so batches are cut by the
    scheduler's own age/deadline pressure (``flush=False``)."""
    outs, i = [], 0
    t0 = time.perf_counter()
    while i < len(plan) or eng.scheduler.depth:
        now = time.perf_counter() - t0
        while i < len(plan) and plan[i].arrival_s <= now:
            eng.submit(plan[i], now=plan[i].arrival_s)
            i += 1
        served = eng.run_batch(flush=False, now=now)
        outs.extend(served)
        if not served:   # nothing ready: wait for arrivals/age, don't spin
            time.sleep(poll_s)
    return outs, time.perf_counter() - t0


def serve_threaded_open_loop(eng: DiffusionEngine, plan, clients: int = 4):
    """Replay a timestamped arrival plan from N concurrent client threads
    through ``AsyncDiffusionEngine`` (split round-robin; each thread
    sleeps until its requests' arrival times).  Returns
    ``(results_in_request_order, wall_s)``."""
    if clients < 1:
        raise ValueError(f"clients must be >= 1, got {clients}")
    futures = [None] * len(plan)
    with AsyncDiffusionEngine(eng) as aeng:
        t0 = time.perf_counter()

        def client(k: int):
            for i in range(k, len(plan), clients):
                req = plan[i]
                delay = req.arrival_s - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                futures[i] = aeng.submit(req)

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        # all clients are done submitting: flush the tail batch instead
        # of letting it age out
        aeng.drain()
        outs = [f.result() for f in futures]
        wall = time.perf_counter() - t0
    return outs, wall


def _default_policy(args):
    """The stream's default cache policy from the CLI flags (shared by
    the in-process and fleet paths so the two serve identical streams)."""
    if args.max_error is not None:
        return policy_lib.FreqCaErrorBudgetPolicy(
            method=args.method, rho=0.25).with_budget(args.max_error)
    return policy_lib.FreqCaPolicy(interval=args.interval,
                                   method=args.method)


def _stream_policies(args, default_pol):
    """Per-request policy cycle for ``--mixed-policies`` (else None)."""
    if not args.mixed_policies:
        return None
    return [default_pol,
            policy_lib.ForaPolicy(interval=args.interval),
            policy_lib.FreqCaAdaptivePolicy(method=args.method,
                                            rho=0.25, tea_threshold=0.3)]


def dit_fns(params, cfg: DiTConfig):
    """The engine's two callables over a DiT: ``full_fn(x, t)`` ->
    (velocity, CRF) and a shape-generic ``from_crf_fn(crf, t)`` (the
    image side is recovered from the token count, so one callable
    decodes every ladder entry)."""
    def full_fn(x, t):
        out = dit.dit_forward(params, x, t.expand(x.shape[0]), cfg)
        return out.velocity, out.crf

    def from_crf_fn(crf, t):
        side = math.isqrt(crf.shape[1]) * cfg.patch_size
        return dit.dit_from_crf(params, crf, t.expand(crf.shape[0]), cfg,
                                side, side)
    return full_fn, from_crf_fn


def fleet_engine_factory(params_np, cfg, size: int, steps: int,
                         batch: int, max_wait: float, method: str,
                         interval: int, max_error, grouped: bool,
                         shed_depth, shed_factor: float, sizes=None,
                         device=None):
    """Zero-arg-able engine builder for fleet workers.

    Module-level (so ``functools.partial`` of it pickles under the spawn
    start method).  ``params_np`` is a numpy tree in ``repro``'s layout
    (``bridge.params_to_wire``: the reference's ``tree_map(np.asarray,
    params)`` for a float32 model, bf16 leaves as uint16 bits); the child
    turns it into tensors on ``device`` (default ``cuda``, resolved here,
    in the child, after its env is set), so no tensor and no device state
    crosses the process boundary.  ``cfg`` is a config id or a
    ``DiTConfig`` (the reference takes an id only; a depth-cut config
    has none).  ``sizes`` declares a multi-resolution shape ladder."""
    if isinstance(cfg, str):
        cfg = config_lib.get_config(cfg)
    dev = device_lib.resolve(device)
    params = bridge.params_from_wire(params_np, cfg, device=dev)
    full_fn, from_crf_fn = dit_fns(params, cfg)
    n_tokens = (size // cfg.patch_size) ** 2
    if max_error is not None:
        pol = policy_lib.FreqCaErrorBudgetPolicy(
            method=method, rho=0.25).with_budget(max_error)
    else:
        pol = policy_lib.FreqCaPolicy(interval=interval, method=method)
    return DiffusionEngine(full_fn, from_crf_fn,
                           (size, size, cfg.in_channels),
                           (n_tokens, cfg.d_model), pol,
                           n_steps=steps, max_batch=batch,
                           max_wait_s=max_wait, group_policies=grouped,
                           shed_depth=shed_depth, shed_factor=shed_factor,
                           shapes=shape_ladder(cfg, sizes or ()),
                           device=dev)


def serve_fleet_open_loop(router, plan, clients: int = 4):
    """Replay a timestamped arrival plan through a ``FleetRouter`` from N
    concurrent client threads — the fleet twin of
    ``serve_threaded_open_loop``."""
    if clients < 1:
        raise ValueError(f"clients must be >= 1, got {clients}")
    futures = [None] * len(plan)
    t0 = time.perf_counter()

    def client(k: int):
        for i in range(k, len(plan), clients):
            req = plan[i]
            delay = req.arrival_s - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            futures[i] = router.submit(req)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    router.drain()
    outs = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    return outs, wall


def _parse_sizes(args, primary: int):
    """The image-size ladder from ``--sizes`` (primary first, deduped)."""
    sizes = [primary]
    for tok in (getattr(args, "sizes", "") or "").split(","):
        tok = tok.strip()
        if tok and int(tok) not in sizes:
            sizes.append(int(tok))
    return sizes


def serve_fleet_main(args, params, size: int, channels: int):
    """The ``--replicas N`` (N > 1) serving path: ship the trained
    parameters to N worker processes, route the stream through the
    fleet frontend, report fleet-wide + per-replica + routing metrics.
    Returns ``{"outs", "wall", "summary"}`` (the ``FleetMetrics``
    summary); the results' latents are host numpy arrays."""
    from repro_torch.serving.fleet import FleetRouter
    default_pol = _default_policy(args)
    pols = _stream_policies(args, default_pol)
    extra = list(pols) if pols else []
    if args.max_error is not None and args.shed_depth is not None:
        extra.append(default_pol.with_budget(
            args.max_error * args.shed_factor))
    cfg = config_lib.get_config("dit-small")
    sizes = _parse_sizes(args, size)
    shapes = shape_ladder(cfg, sizes) if len(sizes) > 1 else None
    factory = functools.partial(
        fleet_engine_factory, bridge.params_to_wire(params, cfg),
        "dit-small", size, args.steps, args.batch, args.max_wait,
        args.method, args.interval, args.max_error, not args.ungrouped,
        args.shed_depth, args.shed_factor,
        sizes=sizes if len(sizes) > 1 else None, device=args.device)
    if args.arrival == "poisson":
        plan = poisson_stream(args.requests, args.rate, size, channels,
                              edit_every=args.edit_every, policies=pols,
                              max_error=args.max_error, shapes=shapes)
    else:
        plan = [r for burst in mixed_stream(
            args.requests, size, channels, edit_every=args.edit_every,
            policies=pols, max_error=args.max_error,
            shapes=shapes) for r in burst]
        for r in plan:
            r.arrival_s = 0.0
    router = FleetRouter(factory, n_replicas=args.replicas,
                         warm={"policies": extra},
                         default_policy=default_pol,
                         max_restarts=args.max_restarts,
                         max_inflight=args.max_inflight,
                         shed_factor=(args.shed_factor
                                      if args.shed_depth is not None
                                      else None))
    print(f"booting {args.replicas} replicas (spawn + warmup) ...",
          flush=True)
    router.start()
    for r in router.replicas:
        print(f"[replica {r.idx}] pid {r.meta['pid']} warmed "
              f"{r.meta['warmup_compiles']} signatures (first runs) in "
              f"{r.meta['warmup_s']:.1f}s; spawn -> ready {r.boot_s:.1f}s")
    try:
        outs, wall = serve_fleet_open_loop(
            router, plan, clients=max(args.clients, 1))
        fm = router.fleet_metrics()
    finally:
        router.shutdown(drain=True)
    s = fm.summary()
    fleet, routing = s["fleet"], s["routing"]
    rps = len(outs) / wall if wall > 0 else float("nan")
    print(f"[fleet  ] served {len(outs)} requests in {wall:.2f}s "
          f"({rps:.2f} req/s) across {fleet['replicas']} replicas")
    print(f"[fleet  ] occupancy {fleet['mean_occupancy']:.2f}  "
          f"latency p50/p95 {fleet['request_latency_p50_s']:.3f}/"
          f"{fleet['request_latency_p95_s']:.3f}s  "
          f"skip-compute {fleet['skip_compute_fraction']:.2f}")
    print(f"[fleet  ] routing: {routing['affinity_hits']} affinity, "
          f"{routing['new_groups']} new groups, {routing['spills']} "
          f"spills, {routing['requeued']} requeued, "
          f"{routing['replicas_lost']} replicas lost")
    if args.max_restarts > 0:
        print(f"[fleet  ] supervision: {routing.get('restarts', 0)} "
              f"restarts, {routing.get('boot_failures', 0)} boot "
              f"failures, {routing.get('replicas_retired', 0)} retired, "
              f"backoff {routing.get('restart_backoff_s', 0.0):.2f}s; "
              f"{routing['stale_pong_kills']} stale-pong kills, "
              f"{routing['poison_quarantined']} quarantined, "
              f"{routing['backpressure_waits']} backpressured "
              f"(peak inflight {routing['peak_inflight']})")
    for idx, pr in s["per_replica"].items():
        print(f"[replica {idx}] {pr['requests']} reqs / "
              f"{pr['batches']} batches, occupancy "
              f"{pr['mean_occupancy']:.2f}, steady recompiles "
              f"{pr['steady_recompiles']}")
    return {"outs": sorted(outs, key=lambda o: o.request_id), "wall": wall,
            "summary": s}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--interval", type=int, default=5)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8,
                    help="max batch (largest bucket signature)")
    ap.add_argument("--method", default="dct", choices=["dct", "fft"])
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="age threshold for batch formation (s)")
    ap.add_argument("--edit-every", type=int, default=5,
                    help="every Nth request is an editing request (0=off)")
    ap.add_argument("--arrival", default="burst",
                    choices=["burst", "poisson"],
                    help="closed-loop bursts or open-loop Poisson client")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="Poisson arrival rate (req/s) for --arrival poisson")
    ap.add_argument("--clients", type=int, default=0,
                    help="N concurrent client threads through the async "
                         "engine for --arrival poisson (0 = single-thread "
                         "sync replay baseline)")
    ap.add_argument("--mixed-policies", action="store_true",
                    help="cycle per-request policies (freqca/fora/freqca_a)"
                         " — lanes in one batch keep their own schedules")
    ap.add_argument("--ungrouped", action="store_true",
                    help="disable policy-homogeneous batch formation "
                         "(mixed-lane batches, one signature per "
                         "lane-policy mix)")
    ap.add_argument("--max-error", type=float, default=None,
                    help="per-request quality SLO: serve through the "
                         "error-budgeted freqca_eb policy, bounding the "
                         "cache error accumulated between full forwards")
    ap.add_argument("--shed-depth", type=int, default=None,
                    help="queue depth at which incoming requests' error "
                         "budgets are relaxed by --shed-factor (load "
                         "shedding: quality, never requests)")
    ap.add_argument("--shed-factor", type=float, default=4.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replica processes behind the fleet "
                         "router; 1 (default) = the in-process engine path")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="restart attempts per replica slot before it is "
                         "permanently retired (fleet supervision; 0 "
                         "disables restarts)")
    ap.add_argument("--max-inflight", type=int, default=0,
                    help="outstanding requests per replica before "
                         "submit() backpressures (0 = unbounded)")
    ap.add_argument("--sizes", default="",
                    help="comma-separated extra image sizes to serve "
                         "alongside the primary (multi-resolution shape "
                         "ladder, e.g. --sizes 16,64)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Train dit-small, then serve the stream (see the module docstring).
    Returns what was served and the trained ``params``: in-process,
    ``{"freqca": run, "full": run, "psnr": [dB per request]}`` where each
    run is ``{"outs", "wall", "summary", "warmup_compiles",
    "steady_recompiles"}``; with ``--replicas N > 1``,
    ``serve_fleet_main``'s result."""
    args = build_parser().parse_args(argv)

    if args.requests < 1:
        raise SystemExit("--requests must be >= 1")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    dev = device_lib.resolve(args.device)
    cfg = config_lib.get_config("dit-small")
    print("training dit-small on synthetic shapes ...", flush=True)
    params = train_dit(cfg, args.train_steps, 16, ckpt_dir="", device=dev)
    size = 32
    if args.replicas > 1:
        return dict(serve_fleet_main(args, params, size, cfg.in_channels),
                    params=params)
    n_tokens = (size // cfg.patch_size) ** 2
    sizes = _parse_sizes(args, size)
    shapes = shape_ladder(cfg, sizes) if len(sizes) > 1 else None
    full_fn, from_crf_fn = dit_fns(params, cfg)

    def engine(policy):
        return DiffusionEngine(full_fn, from_crf_fn,
                               (size, size, cfg.in_channels),
                               (n_tokens, cfg.d_model), policy,
                               n_steps=args.steps, max_batch=args.batch,
                               max_wait_s=args.max_wait,
                               group_policies=not args.ungrouped,
                               shed_depth=args.shed_depth,
                               shed_factor=args.shed_factor,
                               shapes=shapes or (), device=dev)

    default_pol = _default_policy(args)
    policies = _stream_policies(args, default_pol)
    eng_freqca = engine(default_pol)
    eng_full = engine(policy_lib.NoCachePolicy())

    results = {"params": params}
    for name, eng in [("freqca", eng_freqca), ("full", eng_full)]:
        pols = policies if name == "freqca" else None
        # grouped (the default), a policy-pure former only ever cuts
        # uniform signatures: one ladder per compatibility group covers
        # the stream; ungrouped, warm every window the FIFO former can
        # cut (cyclic_signatures)
        sets = cyclic_signatures(pols, args.batch) \
            if pols and args.ungrouped else ()
        extra = list(pols) if pols and not args.ungrouped else []
        if args.max_error is not None and args.shed_depth is not None:
            # shedding mints the relaxed-tier signature: warm it too
            extra.append(default_pol.with_budget(
                args.max_error * args.shed_factor))
        warm = eng.warmup(lane_policy_sets=sets, policies=extra)
        n_exec = eng.compiled_buckets()
        warm_misses = eng.metrics.compile_misses
        print(f"[{name:7s}] warmup: {n_exec} signatures run once "
              f"({len(eng.buckets)} buckets x "
              f"{'policy groups' if not args.ungrouped else 'policy mixes'}"
              f") in {warm:.1f}s")
        max_err = args.max_error if name == "freqca" else None
        if args.arrival == "poisson":
            plan = poisson_stream(args.requests, args.rate, size,
                                  cfg.in_channels,
                                  edit_every=args.edit_every, policies=pols,
                                  max_error=max_err, shapes=shapes)
            if args.clients > 0:
                outs, wall = serve_threaded_open_loop(eng, plan,
                                                      clients=args.clients)
            else:
                outs, wall = serve_open_loop(eng, plan)
        else:
            bursts = mixed_stream(args.requests, size, cfg.in_channels,
                                  edit_every=args.edit_every, policies=pols,
                                  max_error=max_err, shapes=shapes)
            outs, wall = serve_stream(eng, bursts)
        outs.sort(key=lambda o: o.request_id)
        s = eng.metrics.summary()
        results[name] = {
            "outs": outs, "wall": wall, "summary": s,
            "warmup_compiles": warm_misses,
            "steady_recompiles": eng.metrics.compile_misses - warm_misses}
        rps = len(outs) / wall if wall > 0 else float("nan")
        fulls = sorted(o.n_full_steps for o in outs)
        print(f"[{name:7s}] served {len(outs)} requests in {wall:.2f}s "
              f"({rps:.2f} req/s), full steps/req: "
              f"{fulls[0]}..{fulls[-1]}/{args.steps}")
        ttfr = s["time_to_first_result_s"]
        print(f"[{name:7s}] occupancy {s['mean_occupancy']:.2f}  "
              f"latency p50/p95 {s['request_latency_p50_s']:.3f}/"
              f"{s['request_latency_p95_s']:.3f}s  "
              f"skip-compute {s['skip_compute_fraction']:.2f}  "
              f"lane spread {s['max_lane_full_spread']}  "
              f"first runs {s['compile_misses']} "
              f"(steady-state hits {s['compile_hits']}, "
              f"signatures {s['compiled_signatures']}, steady recompiles "
              f"{results[name]['steady_recompiles']})"
              + (f"  ttfr {ttfr:.3f}s" if ttfr is not None else ""))
        if args.max_error is not None and name == "freqca":
            print(f"[{name:7s}] quality SLO: realized error p50/p95 "
                  f"{s['realized_error_p50']:.4f}/"
                  f"{s['realized_error_p95']:.4f} "
                  f"(budget {args.max_error}), "
                  f"budget events {s['budget_events']}, "
                  f"shed events {s['shed_events']}")
        if s["policy_groups"]:
            for key, g in s["per_group"].items():
                print(f"          group {key}: {g['requests']} reqs in "
                      f"{g['batches']} batches, occupancy "
                      f"{g['mean_occupancy']:.2f}"
                      + (f", budget events {g['budget_events']}"
                         if g["budget_events"] else ""))
        if s.get("shape_keys", 0) > 1:
            for key, sh in s["per_shape"].items():
                print(f"          shape {key}: {sh['requests']} reqs in "
                      f"{sh['batches']} batches, occupancy "
                      f"{sh['mean_occupancy']:.2f}")

    f_run, u_run = results["freqca"], results["full"]
    ps = [psnr(f.latents, u.latents)
          for f, u in zip(f_run["outs"], u_run["outs"], strict=True)]
    results["psnr"] = ps
    print(f"speedup {u_run['wall'] / f_run['wall']:.2f}x  PSNR vs uncached: "
          f"{np.mean(ps):.2f} dB (min {np.min(ps):.2f})")
    return results


if __name__ == "__main__":
    main()
