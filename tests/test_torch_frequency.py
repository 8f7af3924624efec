"""Port parity: frequency bases and the Hermite fold (``repro_torch.core``
vs ``repro.core``), on the CPU.

Tolerances: the float64 bases are built by the same numpy arithmetic,
so they agree to 1e-12.  The float32 Hermite folds agree to 1e-5 in
the weights; a forecast is an extrapolation that amplifies the solve's
float32 round-off, so it is held to 1e-4 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frequency as jfreq
from repro.core import hermite as jherm
from repro_torch.core import frequency as tfreq
from repro_torch.core import hermite as therm

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
