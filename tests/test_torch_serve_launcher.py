"""The port's serving launcher (``repro_torch.launch.serve``) against
``repro.launch.serve``, on the CPU at reduced dit-small width.

- ``psnr`` equals the reference's; ``shape_ladder`` and the default /
  mixed policies from the same flags match field for field.
- ``mixed_stream`` and ``poisson_stream`` give the reference's ids,
  seeds, edit positions and strengths, policies, shapes and
  ``arrival_s`` exactly (the same ``RandomState`` draws);
  ``cyclic_signatures`` the same keys.  Edit references differ by
  construction (a ``torch.Generator`` against ``jax.random.key``), so
  the serving checks build the stream in ``repro`` and convert it.
- Through ``serve_stream``, ``serve_open_loop`` and
  ``serve_threaded_open_loop`` the port and ``repro`` serve the same
  requests with the same weights (carried by ``bridge``) and the same
  noise (numpy by seed, in place of each engine's own generator):
  per-request ``n_full_steps`` exactly equal, latents within ``ATOL_REL``
  of the largest (float32: the two packages' GEMMs sum in other
  orders), and the closed loop's batch cuts exactly equal.
- ``fleet_engine_factory`` takes the reference's numpy tree as it is;
  ``bridge``'s wire tree carries bf16 leaves bit for bit.
- ``main([... "--device", "cpu"])`` runs end to end at tiny sizes, and
  without ``--device cpu`` raises where there is no card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import policies as jpol
from repro.diffusion import schedule as jschedule
from repro.launch import serve as jserve
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.serving.engine import DiffusionEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.checkpointing import bridge
from repro_torch.core import policies as tpol
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest

SIZE = 8
N_STEPS = 6
MAX_BATCH = 2
ATOL_REL = 1e-5


# ---------------------------------------------------------------------------
# helpers, streams, flags
# ---------------------------------------------------------------------------

def test_psnr_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, SIZE, SIZE, 4)).astype(np.float32)
    b = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
    got = tserve.psnr(torch.from_numpy(a), torch.from_numpy(b))
    assert got == pytest.approx(jserve.psnr(jnp.asarray(a), jnp.asarray(b)),
                                rel=1e-6)
    assert tserve.psnr(a, b) == got                   # arrays too
    assert tserve.psnr(torch.from_numpy(a), torch.from_numpy(a)) == \
        jserve.psnr(jnp.asarray(a), jnp.asarray(a)) == float("inf")


def _policy_pairs():
    """The launcher's mixed-policy cycle, built by each package from the
    same flags (``_default_policy`` / ``_stream_policies``)."""
    argv = ["--mixed-policies", "--interval", "3", "--method", "fft"]
    jargs = jserve.build_parser().parse_args(argv)
    targs = tserve.build_parser().parse_args(argv)
    jp = jserve._stream_policies(jargs, jserve._default_policy(jargs))
    tp = tserve._stream_policies(targs, tserve._default_policy(targs))
    return jp, tp


def test_flags_and_policies_match_reference():
    jargs = jserve.build_parser().parse_args([])
    targs = tserve.build_parser().parse_args([])
    assert vars(targs) == dict(vars(jargs), device=None)
    jp, tp = _policy_pairs()
    for j, t in zip(jp, tp, strict=True):
        assert type(j).__name__ == type(t).__name__
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    argv = ["--max-error", "0.2"]
    j = jserve._default_policy(jserve.build_parser().parse_args(argv))
    t = tserve._default_policy(tserve.build_parser().parse_args(argv))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jcfg, tcfg = (pkg.get_config("dit-small") for pkg in (jconfigs, tconfigs))
    assert tserve.shape_ladder(tcfg, [32, 16, 64]) == \
        jserve.shape_ladder(jcfg, [32, 16, 64])


def _same_request(t, j, tpols=None, jpols=None):
    assert (t.request_id, t.seed, t.edit_strength, t.max_error,
            t.latent_shape, t.crf_shape, t.arrival_s) == \
        (j.request_id, j.seed, j.edit_strength, j.max_error,
         j.latent_shape, j.crf_shape, j.arrival_s)
    assert (t.init_latents is None) == (j.init_latents is None)
    if t.init_latents is not None:
        assert tuple(t.init_latents.shape) == tuple(j.init_latents.shape)
    if jpols is None:
        assert t.policy is None and j.policy is None
    else:
        assert tpols.index(t.policy) == jpols.index(j.policy)


@pytest.mark.parametrize("mixed", [False, True])
def test_streams_match_reference(mixed):
    jp, tp = _policy_pairs() if mixed else (None, None)
    jcfg, tcfg = (pkg.get_config("dit-small") for pkg in (jconfigs, tconfigs))
    jsh = jserve.shape_ladder(jcfg, [16, 32]) if mixed else None
    tsh = tserve.shape_ladder(tcfg, [16, 32]) if mixed else None
    kw = dict(edit_every=3, max_error=0.1 if mixed else None)
    jb = jserve.mixed_stream(13, 16, 4, policies=jp, shapes=jsh, **kw)
    tb = tserve.mixed_stream(13, 16, 4, policies=tp, shapes=tsh, **kw)
    assert [len(b) for b in tb] == [len(b) for b in jb]
    for t, j in zip(sum(tb, []), sum(jb, []), strict=True):
        _same_request(t, j, tp, jp)
    for seed in (0, 3):
        jplan = jserve.poisson_stream(11, 2.5, 16, 4, policies=jp,
                                      seed=seed, shapes=jsh, **kw)
        tplan = tserve.poisson_stream(11, 2.5, 16, 4, policies=tp,
                                      seed=seed, shapes=tsh, **kw)
        for t, j in zip(tplan, jplan, strict=True):
            _same_request(t, j, tp, jp)          # arrival_s bit for bit
    with pytest.raises(ValueError, match="rate"):
        tserve.poisson_stream(2, 0.0, 16, 4)


@pytest.mark.parametrize("max_batch", [1, 2, 4])
def test_cyclic_signatures_match_reference(max_batch):
    jp, tp = _policy_pairs()
    got = tserve.cyclic_signatures(tp, max_batch)
    want = jserve.cyclic_signatures(jp, max_batch)
    assert [tuple(tp.index(p) for p in key) for key in got] == \
        [tuple(jp.index(p) for p in key) for key in want]


# ---------------------------------------------------------------------------
# serving the same stream: the port against repro
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """A repro and a port engine over one reduced dit-small (repro's
    init, every leaf perturbed so each block contributes), FreqCa
    interval 3, warmed; noise from numpy by seed for both."""
    cj = jconfigs.reduced(jconfigs.get_config("dit-small"))
    ct = tconfigs.reduced(tconfigs.get_config("dit-small"))
    pj = jcommon.init_params(jdit.dit_specs(cj), jax.random.key(3))
    rng = np.random.default_rng(3)
    pj = jax.tree.map(
        lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype),
        pj)
    pt = bridge.params_from_wire(jax.tree.map(np.asarray, pj), ct,
                                 device="cpu")
    tfull, tcrf = tserve.dit_fns(pt, ct)

    def jfull(x, t):
        out = jdit.dit_forward(pj, x, jnp.full((x.shape[0],), t), cj)
        return out.velocity, out.crf

    def jcrf(c, t):
        return jdit.dit_from_crf(pj, c, jnp.full((c.shape[0],), t), cj,
                                 SIZE, SIZE)
    lat = (SIZE, SIZE, cj.in_channels)
    crf = ((SIZE // cj.patch_size) ** 2, cj.d_model)
    jeng = JaxEngine(jfull, jcrf, lat, crf,
                     jpol.FreqCaPolicy(interval=3, method="dct"),
                     n_steps=N_STEPS, max_batch=MAX_BATCH, max_wait_s=0.02)
    teng = DiffusionEngine(tfull, tcrf, lat, crf,
                           tpol.FreqCaPolicy(interval=3, method="dct"),
                           n_steps=N_STEPS, max_batch=MAX_BATCH,
                           max_wait_s=0.02, device="cpu")
    cuts = {"j": [], "t": []}
    jeng.build_x_init = _numpy_x_init(lat, jnp.asarray, cuts["j"])
    teng.build_x_init = _numpy_x_init(lat, torch.from_numpy, cuts["t"])
    jeng.warmup()
    teng.warmup()
    cuts["j"].clear()
    cuts["t"].clear()
    return jeng, teng, cuts


def _numpy_x_init(lat, stack, cuts):
    """build_x_init from numpy noise by seed (the packages' own
    generators differ), editing lanes noised by the reference's
    ``add_noise``, padded lanes zero; records each cut's request ids."""
    def build(plan):
        cuts.append([r.request_id for r in plan.requests])
        lanes = []
        for r in plan.requests:
            noise = np.random.default_rng(r.seed).standard_normal(
                lat).astype(np.float32)
            if r.init_latents is not None:
                noise = np.asarray(jschedule.add_noise(
                    jnp.asarray(np.asarray(r.init_latents)),
                    jnp.asarray(noise), r.edit_strength))
            lanes.append(noise)
        lanes += [np.zeros(lat, np.float32)] * (plan.bucket - plan.n_real)
        return stack(np.stack(lanes))
    return build


def _to_port(req):
    """A repro request as the port's (edit reference as a tensor)."""
    kw = {f.name: getattr(req, f.name)
          for f in dataclasses.fields(DiffusionRequest)}
    if req.init_latents is not None:
        kw["init_latents"] = torch.from_numpy(np.array(req.init_latents))
    return DiffusionRequest(**kw)


def _assert_same_results(touts, jouts, n):
    assert sorted(o.request_id for o in touts) == list(range(n))
    want = {o.request_id: o for o in jouts}
    assert sorted(want) == list(range(n))
    for o in touts:
        w = want[o.request_id]
        assert o.n_full_steps == w.n_full_steps, o.request_id
        wl = np.asarray(w.latents)
        np.testing.assert_allclose(o.latents.numpy(), wl, rtol=0,
                                   atol=ATOL_REL * np.abs(wl).max())


def test_closed_loop_matches_reference(engines):
    jeng, teng, cuts = engines
    bursts = jserve.mixed_stream(7, SIZE, 4, edit_every=3)
    jouts, _ = jserve.serve_stream(jeng, bursts)
    touts, wall = tserve.serve_stream(
        teng, [[_to_port(r) for r in b] for b in bursts])
    assert wall > 0
    _assert_same_results(touts, jouts, 7)
    assert cuts["t"] == cuts["j"] and len(cuts["t"]) >= 4
    cuts["j"].clear()
    cuts["t"].clear()
    assert {o.n_full_steps for o in touts} == {4}    # steps 0, 1, 2, 3


@pytest.mark.parametrize("clients", [0, 2])
def test_open_loops_match_reference(engines, clients):
    """Open loop (one thread) and threaded open loop (two clients):
    arrival timing decides the cuts, so per request only."""
    jeng, teng, cuts = engines
    plan = jserve.poisson_stream(5, 50.0, SIZE, 4, edit_every=2, seed=1)
    tplan = [_to_port(r) for r in plan]
    if clients:
        jouts, _ = jserve.serve_threaded_open_loop(jeng, plan,
                                                   clients=clients)
        touts, _ = tserve.serve_threaded_open_loop(teng, tplan,
                                                   clients=clients)
        assert [o.request_id for o in touts] == list(range(5))
    else:
        jouts, _ = jserve.serve_open_loop(jeng, plan)
        touts, _ = tserve.serve_open_loop(teng, tplan)
    _assert_same_results(touts, jouts, 5)
    cuts["j"].clear()
    cuts["t"].clear()
    with pytest.raises(ValueError, match="clients"):
        tserve.serve_threaded_open_loop(teng, tplan, clients=0)


# ---------------------------------------------------------------------------
# the fleet's engine factory and its wire tree
# ---------------------------------------------------------------------------

def test_fleet_engine_factory_takes_the_reference_tree():
    """The reference's numpy tree (``tree_map(np.asarray, params)``) as
    it is, under a config id or a ``DiTConfig``: the engine it builds
    serves what an engine over ``bridge``'s parameters serves, bit for
    bit."""
    cj = jconfigs.reduced(jconfigs.get_config("dit-small"))
    ct = tconfigs.reduced(tconfigs.get_config("dit-small"))
    tree = jax.tree.map(np.asarray, jcommon.init_params(
        jdit.dit_specs(cj), jax.random.key(4)))
    eng = tserve.fleet_engine_factory(tree, ct, SIZE, N_STEPS, 2, 0.05,
                                      "dct", 3, None, True, None, 4.0,
                                      device="cpu")
    full_fn, from_crf_fn = tserve.dit_fns(
        bridge.params_from_jax_numpy(tree, ct, device="cpu"), ct)
    direct = DiffusionEngine(full_fn, from_crf_fn, eng.latent_shape,
                             eng.crf_shape, eng.policy, n_steps=N_STEPS,
                             max_batch=2, device="cpu")
    assert eng.crf_shape == ((SIZE // 2) ** 2, ct.d_model)
    assert eng.max_batch == 2 and eng.n_steps == N_STEPS
    reqs = [DiffusionRequest(request_id=i, seed=i) for i in range(3)]
    (a, b), (c,) = eng.run_batch(reqs[:2]), eng.run_batch(reqs[2:])
    (x, y), (z,) = direct.run_batch(reqs[:2]), direct.run_batch(reqs[2:])
    for got, want in ((a, x), (b, y), (c, z)):
        assert got.n_full_steps == want.n_full_steps == 4
        assert torch.equal(got.latents, want.latents)
    full_tree = jax.tree.map(np.asarray, jcommon.init_params(
        jdit.dit_specs(jconfigs.get_config("dit-small")),
        jax.random.key(5)))
    eb = tserve.fleet_engine_factory(full_tree, "dit-small", 32, N_STEPS,
                                     2, 0.05, "fft", 3, 0.2, False, 4, 2.0,
                                     sizes=[16], device="cpu")
    assert type(eb.policy).__name__ == "FreqCaErrorBudgetPolicy"
    assert eb.shapes == [((32, 32, 4), (256, 128)), ((16, 16, 4),
                                                      (64, 128))]


def test_wire_tree_carries_bf16_bits():
    """bf16 leaves travel as their raw bits in uint16 arrays (numpy has
    no bf16) and come back bit for bit; a float32 tree is plain numpy."""
    import pickle

    from repro_torch.checkpointing import checkpoint
    from repro_torch.models import dit as tdit
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(
            tconfigs.reduced(tconfigs.get_config("flux1-dev")), n_double=0,
            dtype=dtype)
        params = tdit.init_params(cfg, seed=2, device="cpu")
        wire = pickle.loads(pickle.dumps(bridge.params_to_wire(params,
                                                               cfg)))
        kinds = {a.dtype for a in checkpoint._flatten_with_paths(
            wire).values()}
        assert kinds == {np.dtype(np.uint16 if dtype == "bfloat16"
                                  else np.float32)}
        back = checkpoint._flatten_with_paths(
            bridge.params_from_wire(wire, cfg, device="cpu"))
        want = checkpoint._flatten_with_paths(params)
        assert sorted(back) == sorted(want)
        for k, v in want.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    wire = bridge.params_to_wire(tdit.init_params(bf16, device="cpu"), bf16)
    with pytest.raises(TypeError, match="bf16 bits"):
        bridge.params_from_wire(wire, dataclasses.replace(
            bf16, dtype="float32"), device="cpu")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--arrival", "poisson", "--rate", "50", "--clients", "2"],
])
def test_main_runs_on_the_cpu(argv):
    steps, interval = 5, 2
    res = tserve.main(["--device", "cpu", "--requests", "4", "--steps",
                       str(steps), "--interval", str(interval),
                       "--train-steps", "2", "--batch", "2",
                       "--edit-every", "2", *argv])
    # FreqCa's full steps: every interval-th, and the first three (the
    # history its Hermite forecast needs)
    want = len([i for i in range(steps) if i % interval == 0 or i < 3])
    assert [o.n_full_steps for o in res["freqca"]["outs"]] == [want] * 4
    assert [o.n_full_steps for o in res["full"]["outs"]] == [steps] * 4
    assert all(np.isfinite(p) for p in res["psnr"]) and len(res["psnr"]) == 4
    for run in ("freqca", "full"):
        assert res[run]["steady_recompiles"] == 0
        assert res[run]["warmup_compiles"] == 2      # buckets 1 and 2
        assert all(o.latents.shape == (32, 32, 4)
                   and bool(torch.isfinite(o.latents).all())
                   for o in res[run]["outs"])


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "1", "--train-steps", "1"])
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--requests", "0"])
