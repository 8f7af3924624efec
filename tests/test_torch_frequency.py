"""Port parity: frequency bases, the band split and the Hermite fit and
fold (``repro_torch.core`` vs ``repro.core``), on the CPU.

Tolerances: the float64 bases are built by numpy arithmetic of the same
or a re-associated form, so they agree to 1e-12.  Float32 band splits,
transforms and energies agree to 1e-5 (unit-scale inputs, different
FFT/matmul summation orders; energies relative).  The float32 Hermite
folds agree to 1e-5 in the weights; a forecast is an extrapolation that
amplifies the solve's float32 round-off, so it is held to 1e-4
relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frequency as jfreq
from repro.core import hermite as jherm
from repro.kernels import dct as jdct
from repro_torch.core import frequency as tfreq
from repro_torch.core import hermite as therm
from repro_torch.kernels import dct as tdct
from repro_torch.kernels import ops

SIZES = [(16, 0.25), (64, 0.0625), (100, 0.1), (256, 0.125), (4096, 0.0625)]


@pytest.mark.parametrize("method", ["dct", "fft", "none"])
@pytest.mark.parametrize("n,rho", SIZES)
def test_low_band_basis_matches_reference(method, n, rho):
    want = jfreq._low_band_basis_np(n, rho, method)
    got = tfreq._low_band_basis_np(n, rho, method)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert tfreq.spectral_kept_bins(n, rho, method) == \
        jfreq.spectral_kept_bins(n, rho, method)
    # the float32 tensor the kernels read is the same cast
    np.testing.assert_array_equal(
        tfreq.low_band_basis(n, rho, method).numpy(),
        np.asarray(jfreq.low_band_basis(n, rho, method)))


@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("n,rho", SIZES)
def test_low_pass_rule_matches_reference(method, n, rho):
    """Same kept bins, including the fft rule that an even target
    rounds up to an odd, conjugate-symmetric count."""
    np.testing.assert_array_equal(tfreq.low_pass_mask_np(n, rho, method),
                                  jfreq.low_pass_mask_np(n, rho, method))
    assert tfreq.kept_bins(n, rho, method) == jfreq.kept_bins(n, rho, method)
    if method == "fft":
        assert tfreq.kept_bins(n, rho, method) % 2 == 1


@pytest.mark.parametrize("n", [8, 63, 256])
def test_dct_basis_matches_reference(n):
    np.testing.assert_allclose(tfreq._dct_basis_np(n),
                               jfreq._dct_basis_np(n), atol=1e-12, rtol=0)


def test_basis_caches_are_unbounded():
    assert tfreq._dct_basis_np.cache_info().maxsize is None
    assert tfreq._low_band_basis_np.cache_info().maxsize is None


# activated steps of three lanes on a 20-step grid (warm-up, then every
# 5th step), and the step each lane forecasts next
_GRID = (1.0 - np.arange(21) / 20).astype(np.float32)
_LANES = [([0, 1, 2, 5], 7), ([1, 2, 5, 10], 12), ([2, 5, 10, 15], 18)]


@pytest.mark.parametrize("k,order", [(3, 2), (4, 2), (2, 1)])
def test_hermite_weights_and_predict_match_reference(k, order):
    rng = np.random.default_rng(7)
    ts = np.stack([_GRID[steps[-k:]] for steps, _ in _LANES])
    t_q = _GRID[[q for _, q in _LANES]]
    vals = rng.standard_normal((3, k, 5, 6)).astype(np.float32)
    got_w = therm.eval_weights(torch.from_numpy(ts), torch.from_numpy(t_q),
                               order)
    for lane in range(3):
        want_w = jherm.eval_weights(jnp.asarray(ts[lane]), t_q[lane], order)
        np.testing.assert_allclose(got_w[lane].numpy(), np.asarray(want_w),
                                   atol=1e-5, rtol=1e-5)
        got = therm.predict(torch.from_numpy(ts[lane]),
                            torch.from_numpy(vals[lane]), t_q[lane], order)
        want = jherm.predict(jnp.asarray(ts[lane]), jnp.asarray(vals[lane]),
                             t_q[lane], order)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def test_normalize_times_matches_reference():
    ts = np.array([1.0, 0.8, 0.55], np.float32)
    for tq in (ts, np.float32(0.3)):
        np.testing.assert_allclose(
            therm.normalize_times(torch.from_numpy(ts),
                                  torch.as_tensor(tq)).numpy(),
            np.asarray(jherm.normalize_times(jnp.asarray(ts), tq)),
            atol=1e-7)


@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("s,rho", [(64, 0.0625), (100, 0.1), (256, 0.25)])
def test_band_split_basis_matches_reference(method, s, rho):
    want = jdct._band_split_basis_np(s, rho, method)
    got = tdct._band_split_basis_np(s, rho, method)
    assert got.dtype == np.float64 and got.shape == (s, s)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    # a symmetric, idempotent projection
    np.testing.assert_allclose(got, got.T, atol=1e-12)
    np.testing.assert_allclose(got @ got, got, atol=1e-12)
    assert tdct._band_split_basis_np.cache_info().maxsize is None


_LAYOUTS = [((2, 64, 16), 1), ((2, 64, 16), -2), ((2, 3, 40, 8), -2)]


@pytest.mark.parametrize("method", ["dct", "fft", "none"])
@pytest.mark.parametrize("shape,axis", _LAYOUTS)
def test_decompose_matches_reference(method, shape, axis):
    z = np.random.default_rng(21).standard_normal(shape).astype(np.float32)
    want = jfreq.decompose(jnp.asarray(z), 0.125, method, axis=axis)
    got = tfreq.decompose(torch.from_numpy(z), 0.125, method, axis=axis)
    assert isinstance(got, tfreq.Bands)
    np.testing.assert_allclose(got.low.numpy(), np.asarray(want.low),
                               atol=1e-5)
    np.testing.assert_allclose(got.high.numpy(), np.asarray(want.high),
                               atol=1e-5)
    np.testing.assert_allclose((got.low + got.high).numpy(), z, atol=1e-5)


@pytest.mark.parametrize("method", ["dct", "fft"])
def test_band_energies_and_cosine_similarity_match_reference(method):
    rng = np.random.default_rng(22)
    a, b = (rng.standard_normal((2, 64, 16)).astype(np.float32)
            for _ in range(2))
    want = jfreq.band_energies(jnp.asarray(a), 0.25, method)
    got = tfreq.band_energies(torch.from_numpy(a), 0.25, method)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    mixed = 0.6 * a + 0.4 * b
    for x, y in ((a, b), (a, mixed), (a, a)):
        np.testing.assert_allclose(
            float(tfreq.cosine_similarity(torch.from_numpy(x),
                                          torch.from_numpy(y))),
            float(jfreq.cosine_similarity(jnp.asarray(x), jnp.asarray(y))),
            atol=1e-6)


@pytest.mark.parametrize("axis", [-2, 1])
def test_dct_round_trip_matches_reference(axis):
    x = np.random.default_rng(23).standard_normal((2, 48, 8)).astype(
        np.float32)
    got = tfreq.dct(torch.from_numpy(x), axis=axis)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jfreq.dct(jnp.asarray(x), axis)),
                               atol=1e-5)
    np.testing.assert_allclose(tfreq.idct(got, axis=axis).numpy(), x,
                               atol=1e-5)
    np.testing.assert_array_equal(tfreq.low_pass_mask(48, 0.25, "fft")
                                  .numpy(),
                                  np.asarray(jfreq.low_pass_mask(48, 0.25,
                                                                 "fft")))


def test_decompose_routes_cuda_token_layout_to_the_kernel(monkeypatch):
    """A ``[B, S, D]`` tensor on the card reaches ``ops.band_split`` for
    any S and D (here 100 and 48, neither a multiple of 128): the
    kernel masks its edges, so no shape takes a plain route on the card.
    The CPU tensor stands in for a CUDA one; the kernel wrapper then
    refuses it, which shows the call went to the kernel."""
    calls = []
    real = ops.band_split

    def spy(x, rho, method):
        calls.append((tuple(x.shape), rho, method))
        return real(x, rho, method)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "band_split", spy)
    z = torch.randn(2, 100, 48)
    for axis in (1, -2):
        with pytest.raises(ValueError, match="CUDA"):
            tfreq.decompose(z, 0.0625, "dct", axis=axis)
    assert calls == [((2, 100, 48), 0.0625, "dct")] * 2
    # other layouts keep the plain transform path, on any device
    bands = tfreq.decompose(z[None], 0.0625, "fft", axis=-2)
    assert bands.low.shape == (1, 2, 100, 48) and len(calls) == 2


@pytest.mark.parametrize("k,order", [(3, 2), (4, 2), (2, 1)])
@pytest.mark.parametrize("feat", [(), (5,), (5, 6)])
def test_fit_coefficients_and_predict_from_coeffs_match_reference(
        k, order, feat):
    rng = np.random.default_rng(24)
    ts = _GRID[[1, 2, 5, 10][-k:]]
    vals = rng.standard_normal((k,) + feat).astype(np.float32)
    want = jherm.fit_coefficients(jnp.asarray(ts), jnp.asarray(vals), order)
    got = therm.fit_coefficients(torch.from_numpy(ts),
                                 torch.from_numpy(vals), order)
    assert got.shape == (order + 1,) + feat
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    t_q = _GRID[12]
    want_p = jherm.predict_from_coeffs(want, jnp.asarray(ts), t_q, order)
    got_p = therm.predict_from_coeffs(got, torch.from_numpy(ts), t_q, order)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4,
                               rtol=1e-4)
    # the explicit fit and the folded weights forecast the same value
    np.testing.assert_allclose(
        got_p.numpy(),
        therm.predict(torch.from_numpy(ts), torch.from_numpy(vals), t_q,
                      order).numpy(), atol=1e-4, rtol=1e-4)
