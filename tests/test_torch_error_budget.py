"""Port parity for the error-budget policy ``freqca_eb`` and mixed-policy
batches (``MixedBank``), on the CPU at dit-small width.

The scenarios of ``tests/test_error_budget.py`` run against the port;
then the same parameters and noise (drawn with numpy) go through
``repro``'s and the port's ``sample`` and engines, uniform ``freqca_eb``
batches and ``MixedBank`` batches of ``freqca`` + ``freqca_eb`` +
``none`` lanes alike.

Activation counts (``n_full_lanes``) and budget events must be exactly
equal.  ``decide`` compares ``acc + rate > budget`` in float32, so the
two packages agree on a mask only where the spend sits clear of the
budget: each parity test first asserts that every post-warm-up spend of
its run lies at least ``MARGIN`` (5%) of the budget away from it — the
two packages' realized errors differ by ~1e-6 relative on these inputs
— so a tie fails loudly instead of flaking.  Realized errors agree to
``RTOL`` 1e-4; latents to 1e-5 relative to their largest magnitude, as
in the port's other sampler tests.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core import policies as jpol
from repro.core.policies import freqca_eb as jeb
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jschedule
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.serving.engine import DiffusionEngine as JaxEngine
from repro.serving.engine import DiffusionRequest as JaxRequest
from repro_torch.checkpointing import bridge
from repro_torch.core import cache as tcache
from repro_torch.core import policies as tpol
from repro_torch.core.policies import base as tbase
from repro_torch.core.policies.freqca_eb import (ERROR_TIERS,
                                                 FreqCaErrorBudgetPolicy,
                                                 budget_tier)
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tschedule
from repro_torch.models import dit as tdit
from repro_torch.serving.async_engine import AsyncDiffusionEngine
from repro_torch.serving.engine import DiffusionEngine, DiffusionRequest
from repro_torch.serving.scheduler import Scheduler

SIDE = 8
STEPS = 12
MARGIN = 0.05
RTOL = 1e-4
EB_KW = dict(method="dct", rho=0.25)


def small_params(cfg, seed=0, scale=1e-3):
    """``repro``'s dit init with every leaf perturbed by ``scale``: the
    AdaLN-zero init alone makes the CRF nearly constant (realized
    errors ~1e-5), and 0.02 makes it decorrelate each step (rates > 1);
    at 1e-3 the band rates sit near 0.1, so budgets of 0.2 both skip
    and fire."""
    params = jcommon.init_params(jdit.dit_specs(cfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + scale * rng.standard_normal(a.shape).astype(a.dtype),
        params)


@pytest.fixture(scope="module")
def model():
    cj = jconfigs.reduced(jconfigs.get_config("dit-small"))
    ct = tconfigs.reduced(tconfigs.get_config("dit-small"))
    pj = small_params(cj)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")

    def jfull(x, t):
        out = jdit.dit_forward(pj, x, jnp.full((x.shape[0],), t), cj)
        return out.velocity, out.crf

    def jcrf(c, t):
        return jdit.dit_from_crf(pj, c, jnp.full((c.shape[0],), t), cj,
                                 SIDE, SIDE)

    def tfull(x, t):
        out = tdit.dit_forward(pt, x, t.expand(x.shape[0]), ct)
        return out.velocity, out.crf

    def tcrf(c, t):
        return tdit.dit_from_crf(pt, c, t.expand(c.shape[0]), ct, SIDE, SIDE)
    crf_feat = ((SIDE // 2) ** 2, ct.d_model)
    return cj, crf_feat, (jfull, jcrf), (tfull, tcrf)


@pytest.fixture
def spends(monkeypatch):
    """Records every post-warm-up spend the port's freqca_eb decides on."""
    seen = []
    decide = FreqCaErrorBudgetPolicy.decide

    def spy(self, state, ctx):
        spend = state.acc + (state.rate_low + state.rate_high)
        for s, n in zip(spend.tolist(), state.n_valid.tolist(), strict=True):
            if n >= self.needed_history + 1:
                seen.append((s, self.budget))
        return decide(self, state, ctx)
    monkeypatch.setattr(FreqCaErrorBudgetPolicy, "decide", spy)
    return seen


def assert_clear(spends):
    assert spends, "no post-warm-up decision was made"
    worst = min(abs(s - b) / b for s, b in spends)
    assert worst >= MARGIN, f"a spend sits {worst:.4f} of the budget away"


def _noise(batch, channels, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (batch, SIDE, SIDE, channels)).astype(np.float32)


# ---------------------------------------------------------------------------
# tiers, with_budget, compatibility keys (tests/test_error_budget.py)
# ---------------------------------------------------------------------------

def test_budget_tier_snaps_down_never_up():
    assert ERROR_TIERS == jeb.ERROR_TIERS
    assert budget_tier(0.015) == 0.01
    assert budget_tier(0.1) == 0.1
    assert budget_tier(0.35) == 0.2
    assert budget_tier(7.0) == 1.0
    assert budget_tier(0.001) == 0.01
    assert all(budget_tier(t) == t for t in ERROR_TIERS)
    for e in np.linspace(0.0, 1.5, 61):
        assert budget_tier(float(e)) == jeb.budget_tier(float(e))


def test_with_budget_replaces_and_folds_into_key():
    pol = FreqCaErrorBudgetPolicy(**EB_KW)
    assert pol.with_budget(None) is pol
    tight = pol.with_budget(0.011)
    assert tight.budget == 0.01 and tight is not pol
    key = tpol.compatibility_key
    assert key(tight) != key(pol.with_budget(0.2))
    assert key(pol.with_budget(0.013)) == key(tight)
    fre = tpol.FreqCaPolicy(interval=5)
    assert fre.with_budget(0.05) is fre


def test_spec_route_builds_eb_from_threshold():
    spec = tcache.CachePolicy(kind="freqca_eb", tea_threshold=0.3)
    pol = tpol.resolve(spec)
    assert isinstance(pol, FreqCaErrorBudgetPolicy)
    assert pol.budget == budget_tier(0.3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jpol.resolve(jeb.FreqCaErrorBudgetPolicy(budget=0.2))
    assert pol.compatibility_key()[0] == want.compatibility_key()[0]


# ---------------------------------------------------------------------------
# deterministic budget accounting (decide is pure bookkeeping)
# ---------------------------------------------------------------------------

EB = FreqCaErrorBudgetPolicy(method="dct", rho=0.25, budget=0.1)


def _hot_state(batch=1, rate_low=0.03, rate_high=0.01):
    """Post-warm-up state with known band rates."""
    st = EB.init(batch, (4, 8), device="cpu")
    return st._replace(
        n_valid=torch.full((batch,), EB.needed_history + 1,
                           dtype=torch.int32),
        rate_low=torch.full((batch,), rate_low),
        rate_high=torch.full((batch,), rate_high))


def test_budget_spend_and_carry_over():
    st = _hot_state()                      # rate = 0.04 / cached step
    st, act = EB.decide(st, None)
    assert not bool(act[0])
    assert float(st.acc[0]) == pytest.approx(0.04)
    st, act = EB.decide(st, None)
    assert not bool(act[0])
    assert float(st.acc[0]) == pytest.approx(0.08)
    assert float(st.peak[0]) == pytest.approx(0.08)
    assert int(st.events[0]) == 0


def test_budget_event_triggers_and_resets():
    st = _hot_state()
    for _ in range(2):
        st, act = EB.decide(st, None)
    st, act = EB.decide(st, None)          # would spend 0.12 > 0.1
    assert bool(act[0])
    assert float(st.acc[0]) == pytest.approx(0.0)
    assert int(st.events[0]) == 1
    assert float(st.peak[0]) == pytest.approx(0.08)
    assert float(st.peak[0]) <= EB.budget


def test_rate_above_budget_means_every_step_full():
    st = _hot_state(rate_low=0.2, rate_high=0.05)
    for i in range(3):
        st, act = EB.decide(st, None)
        assert bool(act[0])
        assert int(st.events[0]) == i + 1
    assert float(st.peak[0]) == pytest.approx(0.0)


def test_warmup_fulls_are_not_budget_events():
    st = EB.init(1, (4, 8), device="cpu")
    st = st._replace(rate_low=torch.full((1,), 9.9))
    st, act = EB.decide(st, None)
    assert bool(act[0])
    assert int(st.events[0]) == 0
    st = st._replace(n_valid=torch.full((1,), EB.needed_history,
                                        dtype=torch.int32))
    _, act = EB.decide(st, None)           # one calibration full
    assert bool(act[0])


def test_lanes_spend_independently():
    st = _hot_state(batch=2)
    st = st._replace(rate_low=torch.tensor([0.03, 0.2]))
    st, act = EB.decide(st, None)
    assert not bool(act[0]) and bool(act[1])
    assert float(st.acc[0]) == pytest.approx(0.04)
    assert int(st.events[0]) == 0 and int(st.events[1]) == 1


def test_observe_updates_band_rates():
    st = EB.init(2, (4, 8), device="cpu")
    st = EB.observe(st, torch.tensor([[0.01, 0.02], [0.3, 0.4]]), None)
    np.testing.assert_allclose(st.rate_low.numpy(), [0.01, 0.3])
    np.testing.assert_allclose(st.rate_high.numpy(), [0.02, 0.4])
    fb = EB.error_feedback(st)
    assert isinstance(fb, tbase.ErrorFeedback)
    assert fb.realized.shape == (2,) and fb.events.shape == (2,)


def test_state_bytes_count_feedback_scalars():
    batch = 4
    fre = tpol.FreqCaPolicy(method="dct", rho=0.25, high_order=2)
    eb = FreqCaErrorBudgetPolicy(method="dct", rho=0.25, high_order=2)
    d = (eb.state_bytes(eb.init(batch, (16, 32), device="meta"))
         - fre.state_bytes(fre.init(batch, (16, 32), device="meta")))
    assert d == batch * 5 * 4
    jp = jeb.FreqCaErrorBudgetPolicy(method="dct", rho=0.25, high_order=2)
    assert eb.state_bytes(eb.init(batch, (16, 32), device="meta")) == \
        jp.state_bytes(jax.eval_shape(lambda: jp.init(batch, (16, 32))))


# ---------------------------------------------------------------------------
# end to end on synthetic rough dynamics (no model)
# ---------------------------------------------------------------------------

def _rough_fns(s=4, d=8, size=4, ch=2, amp=0.3, freq=8.0):
    """CRF oscillates fast in t, so Hermite forecasts err at a rate the
    budget can meter.  s*d must equal size*size*ch."""
    def full_fn(x, t):
        crf = torch.tanh(x.reshape(x.shape[0], s, d)) + amp * torch.sin(
            freq * t)
        return crf.reshape(x.shape) * 0.1, crf

    def from_crf_fn(crf, t):
        return crf.reshape(crf.shape[0], size, size, ch) * 0.1
    return full_fn, from_crf_fn


def _run_eb(budget, n_steps=40):
    full_fn, from_crf_fn = _rough_fns()
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 4, 2)).astype(np.float32))
    pol = FreqCaErrorBudgetPolicy(method="dct", rho=0.25).with_budget(budget)
    return tsampler.sample(full_fn, from_crf_fn, x0,
                           tschedule.timesteps(n_steps), pol, (2, 4, 8))


def test_eb_realized_error_respects_budget():
    for budget in (0.02, 0.1, 0.5):
        res = _run_eb(budget)
        assert res.feedback is not None
        assert float(res.feedback.realized.max()) <= budget + 1e-6


def test_eb_tighter_budget_means_more_fulls():
    fulls = [_run_eb(b).n_full for b in (0.02, 0.1, 0.5)]
    assert fulls == sorted(fulls, reverse=True), fulls
    assert fulls[0] > fulls[-1], fulls
    assert int(_run_eb(0.02).feedback.events.sum()) > 0


def test_non_feedback_policies_report_no_feedback():
    full_fn, from_crf_fn = _rough_fns()
    x0 = torch.zeros((2, 4, 4, 2))
    for pol in (tpol.NoCachePolicy(),
                tpol.FreqCaPolicy(interval=3, method="dct", rho=0.25),
                tpol.ForaPolicy(interval=2),
                tpol.FreqCaAdaptivePolicy(method="dct", rho=0.25,
                                          tea_threshold=0.3),
                (tpol.FreqCaPolicy(interval=3, method="dct", rho=0.25),
                 tpol.NoCachePolicy())):
        res = tsampler.sample(full_fn, from_crf_fn, x0,
                              tschedule.timesteps(12), pol, (2, 4, 8))
        assert res.feedback is None, pol


# ---------------------------------------------------------------------------
# sampler parity with repro at dit-small width
# ---------------------------------------------------------------------------

MIXED = (("FreqCaPolicy", dict(interval=3, method="dct", rho=0.25)),
         ("FreqCaErrorBudgetPolicy", dict(EB_KW, budget=0.2)),
         ("NoCachePolicy", {}))


@pytest.mark.parametrize("lanes", [
    (("FreqCaErrorBudgetPolicy", dict(EB_KW, budget=0.2)),) * 3,
    (("FreqCaErrorBudgetPolicy", dict(EB_KW, budget=0.1, high_order=1)),)
    * 3,
    MIXED,
], ids=["eb-0.2", "eb-0.1-order1", "mixed"])
def test_sample_matches_reference(model, spends, lanes):
    cj, crf_feat, (jfull, jcrf), (tfull, tcrf) = model
    jp = tuple(getattr(jpol, name)(**dict(kw)) for name, kw in lanes)
    tp = tuple(getattr(tpol, name)(**dict(kw)) for name, kw in lanes)
    x0 = _noise(3, cj.in_channels)
    crf_shape = (3,) + crf_feat
    got = tsampler.sample(tfull, tcrf, torch.from_numpy(x0),
                          tschedule.timesteps(STEPS), tp, crf_shape)
    assert_clear(spends)
    assert isinstance(tpol.bank(tp, 3), tpol.MixedBank if lanes == MIXED
                      else tpol.UniformBank)
    want = jsampler.sample(jfull, jcrf, jnp.asarray(x0),
                           jschedule.timesteps(STEPS), jp, crf_shape)
    assert got.n_full == int(want.n_full)
    np.testing.assert_array_equal(got.n_full_lanes.numpy(),
                                  np.asarray(want.n_full_lanes))
    np.testing.assert_array_equal(got.feedback.events.numpy(),
                                  np.asarray(want.feedback.events))
    np.testing.assert_allclose(got.feedback.realized.numpy(),
                               np.asarray(want.feedback.realized),
                               rtol=RTOL, atol=0)
    # the inputs exercise the budget: some lane skips, some event fires
    assert int(got.n_full_lanes.min()) < STEPS
    assert int(got.feedback.events.sum()) > 0
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x,
                               atol=1e-5 * np.abs(want_x).max())


def test_mixed_bank_lanes_equal_solo_samples(model):
    """Each lane of a freqca + freqca_eb + none batch equals that lane
    sampled alone under its own policy."""
    cj, crf_feat, _, (tfull, tcrf) = model
    tp = tuple(getattr(tpol, name)(**dict(kw)) for name, kw in MIXED)
    x0 = torch.from_numpy(_noise(3, cj.in_channels))
    ts = tschedule.timesteps(STEPS)
    got = tsampler.sample(tfull, tcrf, x0, ts, tp, (3,) + crf_feat)
    for j, pol in enumerate(tp):
        solo = tsampler.sample(tfull, tcrf, x0[j:j + 1], ts, pol,
                               (1,) + crf_feat)
        assert int(got.n_full_lanes[j]) == int(solo.n_full_lanes[0])
        if pol.uses_error_feedback:
            assert int(got.feedback.events[j]) == int(solo.feedback.events[0])
            np.testing.assert_allclose(float(got.feedback.realized[j]),
                                       float(solo.feedback.realized[0]),
                                       rtol=RTOL)
        else:
            assert solo.feedback is None
            assert int(got.feedback.events[j]) == 0
        want = solo.x[0]
        torch.testing.assert_close(got.x[j], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_mixed_bank_update_leaves_inactive_lane_state_intact():
    """The rings push in place: a lane whose mask bit is off keeps its
    state, bit for bit, and a measured error is scored before the push."""
    fq = tpol.FreqCaPolicy(method="dct", rho=0.25)
    eb = FreqCaErrorBudgetPolicy(method="dct", rho=0.25)
    bank = tpol.bank((fq, eb), 2)
    state = bank.init((16, 8), torch.float32, (4, 4, 8), torch.float32,
                      device="cpu")
    before = tbase.tree_clone(state)
    ctx = tbase.StepContext(step_idx=0, t_now=torch.tensor(0.9),
                            x=torch.zeros(2, 4, 4, 8), batch=2,
                            feat_shape=(16, 8))
    crf = torch.randn(2, 16, 8)
    err = bank.measure_error(state, crf, ctx)
    assert err[0] is None and tuple(err[1].shape) == (1, 2)
    new = bank.apply_update(state, crf, ctx, torch.tensor([True, False]))
    new = bank.observe(new, err, ctx, torch.tensor([True, False]))
    for old, kept in zip(tbase.tree_leaves(before[1]),
                         tbase.tree_leaves(new[1]), strict=True):
        assert torch.equal(old, kept)
    for old, now in zip(tbase.tree_leaves(before[1]),
                        tbase.tree_leaves(state[1]), strict=True):
        assert torch.equal(old, now)
    assert int(new[0].n_valid[0]) == 1


# ---------------------------------------------------------------------------
# engines: per-request SLO reports, the port against repro
# ---------------------------------------------------------------------------

def _numpy_noise_x_init(latent, stack):
    """build_x_init from numpy noise by seed, for both packages (their
    own noise generators differ); padded lanes zero."""
    def build(plan):
        lanes = [np.random.default_rng(r.seed).standard_normal(
            latent).astype(np.float32) for r in plan.requests]
        lanes += [np.zeros(latent, np.float32)] * (plan.bucket - plan.n_real)
        return stack(np.stack(lanes))
    return build


def _engines(model, policy, **kw):
    cj, crf_feat, (jfull, jcrf), (tfull, tcrf) = model
    lat = (SIDE, SIDE, cj.in_channels)
    jeng = JaxEngine(jfull, jcrf, lat, crf_feat, policy[0], n_steps=STEPS,
                     max_batch=2, **kw)
    teng = DiffusionEngine(tfull, tcrf, lat, crf_feat, policy[1],
                           n_steps=STEPS, max_batch=2, device="cpu", **kw)
    jeng.build_x_init = _numpy_noise_x_init(lat, jnp.asarray)
    teng.build_x_init = _numpy_noise_x_init(lat, torch.from_numpy)
    return jeng, teng


@pytest.mark.parametrize("group_policies", [False, True])
def test_engine_slo_reports_match_reference(model, spends, group_policies):
    """A stream of freqca, freqca_eb (with max_error) and none requests:
    per-request n_full_steps, budget_events and realized_error equal
    repro's engine's; ungrouped, the cuts mix policies (MixedBank)."""
    fq = tuple(pkg.FreqCaPolicy(interval=3, method="dct", rho=0.25)
               for pkg in (jpol, tpol))
    eb = tuple(pkg.FreqCaErrorBudgetPolicy(high_order=1, **EB_KW)
               for pkg in (jpol, tpol))
    none = (jpol.NoCachePolicy(), tpol.NoCachePolicy())
    lanes = [(fq, None), (eb, 0.1), (eb, 0.15), (none, None), (eb, 0.1)]
    jeng, teng = _engines(model, fq, group_policies=group_policies)
    for i, (pol, max_err) in enumerate(lanes):
        jeng.submit(JaxRequest(request_id=i, seed=40 + i, policy=pol[0],
                               max_error=max_err), now=0.0)
        teng.submit(DiffusionRequest(request_id=i, seed=40 + i,
                                     policy=pol[1], max_error=max_err),
                    now=0.0)
    want = {r.request_id: r for r in jeng.serve_until_drained()}
    got = {r.request_id: r for r in teng.serve_until_drained()}
    assert_clear(spends)
    assert sorted(got) == sorted(want)
    for i, g in got.items():
        w = want[i]
        assert (g.n_full_steps, g.budget_events, g.bucket) == \
            (w.n_full_steps, w.budget_events, w.bucket)
        if w.realized_error is None:
            assert g.realized_error is None
        else:
            np.testing.assert_allclose(g.realized_error, w.realized_error,
                                       rtol=RTOL)
    assert got[1].realized_error <= 0.1 + 1e-6
    assert min(r.n_full_steps for r in got.values()) < STEPS
    assert sum(r.budget_events or 0 for r in got.values()) > 0
    js, ts_ = jeng.metrics.summary(), teng.metrics.summary()
    for k in ("requests", "batches", "budget_events", "full_step_fraction",
              "policy_groups", "max_lane_full_spread"):
        assert ts_[k] == js[k], k


def test_engine_reports_realized_error_and_metrics(model):
    _, crf_feat, _, (tfull, tcrf) = model
    eng = DiffusionEngine(tfull, tcrf, (SIDE, SIDE, 4), crf_feat,
                          FreqCaErrorBudgetPolicy(**EB_KW), n_steps=STEPS,
                          max_batch=4, device="cpu")
    reqs = [DiffusionRequest(request_id=i, seed=i, max_error=0.2)
            for i in range(3)]
    outs = eng.run_batch(reqs=reqs, now=0.0)
    assert len(outs) == 3
    for o in outs:
        assert o.realized_error is not None
        assert o.realized_error <= budget_tier(0.2) + 1e-6
        assert isinstance(o.budget_events, int)
    s = eng.metrics.summary()
    assert s["realized_error_p95"] <= budget_tier(0.2) + 1e-6
    assert s["budget_events"] == sum(o.budget_events for o in outs)
    assert s["shed_events"] == 0
    (group,) = s["per_group"].values()
    assert "budget_events" in group and "realized_error_p95" in group
    snap = eng.metrics.snapshot().summary()
    assert snap["realized_error_p95"] == s["realized_error_p95"]


def test_run_batch_reqs_equals_submit_then_run(model):
    _, crf_feat, _, (tfull, tcrf) = model
    eb = FreqCaErrorBudgetPolicy(**EB_KW)

    def reqs():
        return [DiffusionRequest(request_id=i, seed=i, max_error=0.2)
                for i in range(2)]

    def engine():
        return DiffusionEngine(tfull, tcrf, (SIDE, SIDE, 4), crf_feat, eb,
                               n_steps=STEPS, max_batch=4, device="cpu")
    out_a = engine().run_batch(reqs=reqs(), now=0.0)
    eng_b = engine()
    for r in reqs():
        eng_b.submit(r, now=0.0)
    out_b = eng_b.run_batch(now=0.0)
    for a, b in zip(out_a, out_b, strict=True):
        assert torch.equal(a.latents, b.latents)
        assert a.realized_error == b.realized_error


def test_no_budget_requests_are_bitwise_pre_slo(model):
    """max_error=None leaves the serving path untouched: the same
    results with or without shedding, grouped or not, sync or async,
    and no SLO fields reported."""
    _, crf_feat, _, (tfull, tcrf) = model
    fre = tpol.FreqCaPolicy(interval=3)

    def engine(**kw):
        return DiffusionEngine(tfull, tcrf, (SIDE, SIDE, 4), crf_feat, fre,
                               n_steps=STEPS, max_batch=4, device="cpu",
                               **kw)

    def reqs():
        return [DiffusionRequest(request_id=i, seed=i) for i in range(4)]
    golden = engine().run_batch(reqs=reqs(), now=0.0)
    assert all(o.realized_error is None and o.budget_events is None
               for o in golden)
    for eng in (engine(shed_depth=1, shed_factor=8.0),
                engine(group_policies=False)):
        for g, o in zip(golden, eng.run_batch(reqs=reqs(), now=0.0),
                        strict=True):
            assert torch.equal(g.latents, o.latents)
            assert o.realized_error is None
    inner = engine()
    with AsyncDiffusionEngine(inner) as aeng:
        futs = [aeng.submit(r) for r in reqs()]
        outs = {f.result(timeout=60).request_id: f.result() for f in futs}
    for g in golden:
        assert torch.equal(g.latents, outs[g.request_id].latents)
    s = inner.metrics.summary()
    assert s["realized_error_p95"] is None and s["budget_events"] == 0


# ---------------------------------------------------------------------------
# load shedding: relax budgets under queue pressure, never drop
# ---------------------------------------------------------------------------

def test_shed_relaxes_effective_budget_never_drops():
    eb = FreqCaErrorBudgetPolicy(**EB_KW)
    sched = Scheduler(max_batch=4, default_policy=eb, shed_depth=2,
                      shed_factor=4.0, group_policies=True,
                      clock=lambda: 0.0)
    reqs = [DiffusionRequest(request_id=i, seed=i, max_error=0.05)
            for i in range(4)]
    for r in reqs:
        sched.submit(r, now=0.0)
    assert [r.effective_max_error for r in reqs] == \
        pytest.approx([0.05, 0.05, 0.2, 0.2])
    assert sched.shed_events == 2
    assert {sched.effective_policy(r).budget for r in reqs} == \
        {budget_tier(0.05), budget_tier(0.2)}
    served = []
    while len(sched):
        plan = sched.form_batch(now=0.0, flush=True)
        served += [r.request_id for r in plan.requests]
        assert len({sched.effective_policy(r).budget
                    for r in plan.requests}) == 1
    assert sorted(served) == [0, 1, 2, 3]


def test_no_shed_below_depth_and_no_budget_requests_untouched():
    eb = FreqCaErrorBudgetPolicy(**EB_KW)
    sched = Scheduler(max_batch=8, default_policy=eb, shed_depth=100,
                      shed_factor=4.0, clock=lambda: 0.0)
    a = DiffusionRequest(request_id=0, seed=0, max_error=0.05)
    b = DiffusionRequest(request_id=1, seed=1)
    sched.submit(a, now=0.0)
    sched.submit(b, now=0.0)
    assert a.effective_max_error == 0.05
    assert b.effective_max_error is None
    assert sched.shed_events == 0
    assert sched.effective_policy(b) == eb
