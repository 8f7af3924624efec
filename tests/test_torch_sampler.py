"""Port parity for the sampler as a library: the same parameters and
``x0`` sampled by ``repro`` and by the port under ``none``, FreqCa with
dct and fft, and every other registered policy (golden equivalence), on
the CPU; and the uncached reference trajectory of the frequency
analysis.

Activation counts must be equal; latents and CRFs agree to 1e-5
relative to their largest magnitude (float32 over 10 Euler steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpol
from repro.diffusion import sampler as jsampler
from repro.diffusion import schedule as jschedule
from repro.models import dit as jdit
from repro_torch.checkpointing import bridge
from repro_torch.core import policies as tpol
from repro_torch.diffusion import sampler as tsampler
from repro_torch.diffusion import schedule as tschedule
from repro_torch.models import dit as tdit
from test_torch_dit import SIDE, _configs, jax_params

STEPS = 10


def denoisers(cj, ct, pj, pt, txt):
    def jfull(x, t):
        out = jdit.dit_forward(pj, x, jnp.full((x.shape[0],), t), cj,
                               jnp.asarray(txt[:x.shape[0]]))
        return out.velocity, out.crf

    def jcrf(c, t):
        return jdit.dit_from_crf(pj, c, jnp.full((c.shape[0],), t), cj,
                                 SIDE, SIDE)

    def tfull(x, t):
        out = tdit.dit_forward(pt, x, t.expand(x.shape[0]), ct,
                               torch.from_numpy(txt[:x.shape[0]]))
        return out.velocity, out.crf

    def tcrf(c, t):
        return tdit.dit_from_crf(pt, c, t.expand(c.shape[0]), ct, SIDE, SIDE)
    return (jfull, jcrf), (tfull, tcrf)


@pytest.fixture(scope="module")
def model():
    cj, ct = _configs()
    pj = jax_params(cj, seed=5)
    pt = bridge.params_from_jax_numpy(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")
    # one prompt for both lanes: a lane's result must not depend on its
    # position in the batch
    txt = np.repeat(np.random.default_rng(6).standard_normal(
        (1, cj.n_text_tokens, cj.text_dim)).astype(np.float32), 2, axis=0)
    return cj, ct, denoisers(cj, ct, pj, pt, txt)


def test_timesteps_are_bit_equal():
    for n in (10, 20, 50):
        np.testing.assert_array_equal(tschedule.timesteps(n).numpy(),
                                      np.asarray(jschedule.timesteps(n)))


@pytest.mark.parametrize("policy", [
    dict(kind="none"),
    dict(kind="freqca", interval=3, method="dct", rho=0.25),
    dict(kind="freqca", interval=3, method="fft", rho=0.25),
    dict(kind="freqca", interval=4, method="dct", rho=0.25, high_order=0),
])
def test_sample_matches_reference(model, policy):
    cj, ct, ((jfull, jcrf), (tfull, tcrf)) = model
    kw = {k: v for k, v in policy.items() if k != "kind"}
    if policy["kind"] == "none":
        jp, tp = jpol.NoCachePolicy(), tpol.NoCachePolicy()
    else:
        jp, tp = jpol.FreqCaPolicy(**kw), tpol.FreqCaPolicy(**kw)
    x0 = np.random.default_rng(7).standard_normal(
        (2, SIDE, SIDE, cj.in_channels)).astype(np.float32)
    crf_shape = (2, (SIDE // 2) ** 2, cj.d_model)
    want = jsampler.sample(jfull, jcrf, jnp.asarray(x0),
                           jschedule.timesteps(STEPS), jp, crf_shape)
    got = tsampler.sample(tfull, tcrf, torch.from_numpy(x0),
                          tschedule.timesteps(STEPS), tp, crf_shape)
    assert got.n_full == int(want.n_full)
    np.testing.assert_array_equal(got.n_full_lanes.numpy(),
                                  np.asarray(want.n_full_lanes))
    if policy["kind"] == "freqca":
        assert got.n_full < STEPS
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x,
                               atol=1e-5 * np.abs(want_x).max())


def test_trajectory_and_lane_counts(model):
    _, _, (_, (tfull, tcrf)) = model
    x0 = torch.zeros((1, SIDE, SIDE, 16))
    res = tsampler.sample(tfull, tcrf, x0, tschedule.timesteps(6),
                          tpol.FreqCaPolicy(interval=5), (1, 16, 64),
                          return_trajectory=True)
    assert res.trajectory.shape == (6, 1, SIDE, SIDE, 16)
    assert torch.equal(res.trajectory[-1], res.x)
    # warm-up steps 0-2 plus scheduled step 5
    assert res.n_full == 4 and res.n_full_lanes.tolist() == [4]


class _Lane1AlwaysFull(tpol.FreqCaPolicy):
    """A per-lane policy: lane 0 keeps the FreqCa schedule, every other
    lane activates on every step."""
    per_lane = True

    def decide(self, state, ctx):
        state, mask = super().decide(state, ctx)
        return state, mask | (torch.arange(ctx.batch) >= 1)


def test_per_lane_masks_keep_each_lane_on_its_own_schedule(model):
    """Lane-varying masks: the batch forwards when any lane activates,
    and each lane still matches its solo run (lane 0 under FreqCa,
    lane 1 uncached)."""
    _, _, (_, (tfull, tcrf)) = model
    kw = dict(interval=3, method="dct", rho=0.25)
    x0 = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, SIDE, SIDE, 16)).astype(np.float32))
    ts = tschedule.timesteps(STEPS)
    crf = (SIDE // 2) ** 2, 64
    got = tsampler.sample(tfull, tcrf, x0, ts, _Lane1AlwaysFull(**kw),
                          (2,) + crf)
    solo0 = tsampler.sample(tfull, tcrf, x0[:1], ts,
                            tpol.FreqCaPolicy(**kw), (1,) + crf)
    solo1 = tsampler.sample(tfull, tcrf, x0[1:], ts, tpol.NoCachePolicy(),
                            (1,) + crf)
    assert got.n_full == STEPS
    assert got.n_full_lanes.tolist() == [solo0.n_full, STEPS]
    for lane, solo in ((0, solo0), (1, solo1)):
        want = solo.x[0]
        torch.testing.assert_close(got.x[lane], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# every policy this slice adds, at settings where each lane caches some
# steps.  The adaptive thresholds sit clear of what these inputs
# measure: TeaCache's accumulator reads ~0.031 two steps after a reset
# and ~0.046 three steps after (threshold 0.038); FreqCa-A's projected
# error stays below 1.0 one step after a full step and reads 1.63 or
# more when it fires (threshold 1.5).
GOLDEN = {
    "taylorseer": lambda pkg: pkg.TaylorSeerPolicy(interval=3),
    "fora": lambda pkg: pkg.ForaPolicy(interval=3),
    "foca": lambda pkg: pkg.FoCaPolicy(interval=4, high_order=1),
    "teacache": lambda pkg: pkg.TeaCachePolicy(tea_threshold=0.038),
    "freqca_a": lambda pkg: pkg.FreqCaAdaptivePolicy(
        method="dct", rho=0.25, tea_threshold=1.5),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_equivalence_of_new_policies(model, name):
    """Each new policy object, through the port's sampler, activates on
    the same steps per lane as ``repro``'s and gives the same latents."""
    cj, ct, ((jfull, jcrf), (tfull, tcrf)) = model
    jp, tp = GOLDEN[name](jpol), GOLDEN[name](tpol)
    x0 = np.random.default_rng(9).standard_normal(
        (2, SIDE, SIDE, cj.in_channels)).astype(np.float32)
    crf_shape = (2, (SIDE // 2) ** 2, cj.d_model)
    want = jsampler.sample(jfull, jcrf, jnp.asarray(x0),
                           jschedule.timesteps(STEPS), jp, crf_shape)
    got = tsampler.sample(tfull, tcrf, torch.from_numpy(x0),
                          tschedule.timesteps(STEPS), tp, crf_shape)
    assert got.n_full == int(want.n_full)
    np.testing.assert_array_equal(got.n_full_lanes.numpy(),
                                  np.asarray(want.n_full_lanes))
    assert int(got.n_full_lanes.min()) < STEPS
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x,
                               atol=1e-5 * np.abs(want_x).max())


def test_reference_features_match_reference(model):
    cj, _, ((jfull, _), (tfull, _)) = model
    x0 = np.random.default_rng(10).standard_normal(
        (2, SIDE, SIDE, cj.in_channels)).astype(np.float32)
    want = jsampler.reference_features(jfull, jnp.asarray(x0),
                                       jschedule.timesteps(6))
    got = tsampler.reference_features(tfull, torch.from_numpy(x0),
                                      tschedule.timesteps(6))
    assert got[1].shape == (6, 2, SIDE, SIDE, cj.in_channels)
    assert got[2].shape == (6, 2, (SIDE // 2) ** 2, cj.d_model)
    assert torch.equal(got[1][-1], got[0])
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())
