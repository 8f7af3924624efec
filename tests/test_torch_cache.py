"""Port parity: the legacy function-style cache API
(``repro_torch.core.cache`` vs ``repro.core.cache``) and the string-kind
spec's resolution to the port's policy objects, on the CPU.

Activation decisions, timestamps and byte counts must be equal; the
float32 caches agree to 1e-5 absolute (unit-scale inputs; band splits
summed in different orders) and forecasts to 1e-4 (the extrapolation
amplifies the solve's float32 round-off).
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import policies as jpol
from repro_torch.core import cache as tcache
from repro_torch.core import policies as tpol

STEPS = 12
GRID = np.linspace(1.0, 0.0, STEPS + 1).astype(np.float32)

KINDS = [
    dict(kind="freqca", method="dct", rho=0.125),
    dict(kind="freqca", method="fft", rho=0.125),
    dict(kind="freqca", method="dct", rho=0.25, low_order=1, high_order=1),
    dict(kind="freqca_a", method="dct", rho=0.125),
    dict(kind="taylorseer"),
    dict(kind="foca", high_order=1),
    dict(kind="fora"),
    dict(kind="teacache"),
    dict(kind="none"),
]


def _specs(kw):
    kw = dict(interval=3, **kw)
    return jcache.CachePolicy(**kw), tcache.CachePolicy(**kw)


def _ids(kw):
    return "-".join(str(v) for v in kw.values())


@pytest.mark.parametrize("kw", KINDS, ids=_ids)
def test_legacy_sequence_matches_reference(kw):
    """init_state, then 12 steps of should_activate / update on
    activated steps / predict on the others, then cache_bytes."""
    jp, tp = _specs(kw)
    assert tp.cache_units == jp.cache_units
    assert (tp.k_low, tp.k_high) == (jp.k_low, jp.k_high)
    feat = (2, 32, 8)
    js = jcache.init_state(jp, feat)
    ts_ = tcache.init_state(tp, feat)
    rng = np.random.default_rng(31)
    n_act = 0
    for i in range(STEPS):
        t = GRID[i]
        jact = jcache.should_activate(jp, js, jnp.int32(i))
        tact = tcache.should_activate(tp, ts_, i)
        assert tact.dtype == torch.bool and bool(tact) == bool(jact)
        if bool(tact):
            n_act += 1
            z = rng.standard_normal(feat).astype(np.float32)
            js = jcache.update(jp, js, jnp.asarray(z), t)
            ts_ = tcache.update(tp, ts_, torch.from_numpy(z),
                                torch.tensor(t))
        else:
            want = jcache.predict(jp, js, t)
            got = tcache.predict(tp, ts_, torch.tensor(t))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4)
    assert 0 < n_act <= STEPS
    if kw["kind"] != "none":
        assert n_act < STEPS
    for jleaf, tleaf in zip(js, ts_, strict=True):
        assert tleaf.dtype == getattr(torch, str(jleaf.dtype))
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   atol=1e-5)
    assert tcache.cache_bytes(ts_) == jcache.cache_bytes(js)
    assert tcache.cache_bytes(ts_, tp) == jcache.cache_bytes(js, jp)


def test_update_leaves_the_old_state_intact():
    """The legacy state is functional, as in the reference."""
    _, tp = _specs(dict(kind="freqca"))
    state = tcache.init_state(tp, (1, 16, 4))
    before = [t.clone() for t in state]
    new = tcache.update(tp, state, torch.randn(1, 16, 4), 1.0)
    for a, b in zip(state, before, strict=True):
        assert torch.equal(a, b)
    assert int(new.n_valid) == 1 and float(new.ts_high[-1]) == 1.0


def test_layerwise_api_matches_reference():
    jp, tp = _specs(dict(kind="taylorseer", high_order=2))
    rng = np.random.default_rng(32)
    feat = (2, 16, 4)
    js = jcache.layerwise_init(jp, 3, feat)
    ts_ = tcache.layerwise_init(tp, 3, feat)
    for t in GRID[:4]:
        r = rng.standard_normal((3,) + feat).astype(np.float32)
        js = jcache.layerwise_update(jp, js, jnp.asarray(r), t)
        ts_ = tcache.layerwise_update(tp, ts_, torch.from_numpy(r),
                                      torch.tensor(t))
    for jleaf, tleaf in zip(js, ts_, strict=True):
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    h0 = rng.standard_normal(feat).astype(np.float32)
    want = jcache.layerwise_predict(jp, js, GRID[5], jnp.asarray(h0))
    got = tcache.layerwise_predict(tp, ts_, torch.tensor(GRID[5]),
                                   torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


_PORT_CLASSES = {
    "freqca": tpol.FreqCaPolicy, "freqca_a": tpol.FreqCaAdaptivePolicy,
    "taylorseer": tpol.TaylorSeerPolicy, "foca": tpol.FoCaPolicy,
    "fora": tpol.ForaPolicy, "teacache": tpol.TeaCachePolicy,
    "none": tpol.NoCachePolicy, "freqca_eb": tpol.FreqCaErrorBudgetPolicy,
}


@pytest.mark.parametrize("kind", sorted(_PORT_CLASSES))
def test_resolve_gives_the_port_objects(kind, monkeypatch):
    """``CachePolicy(kind=k).resolve()`` warns (once per process) and
    returns the port's object, equal in value to the reference's."""
    monkeypatch.setattr(tcache, "_RESOLVE_WARNED", False)
    jp, tp = _specs(dict(kind=kind, rho=0.25, high_order=1))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        pol = tp.resolve()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tp.resolve() == pol           # no second warning
    assert type(pol) is _PORT_CLASSES[kind]
    assert tpol.resolve(pol) is pol
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jp.resolve()
    assert pol.name == want.name
    assert pol.compatibility_key()[0] == want.compatibility_key()[0]
    assert pol.needed_history == want.needed_history
    assert pol.cache_units == want.cache_units
    assert _fields(pol) == _fields(want)


def _fields(pol):
    return {f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)}


def test_unregistered_kinds_raise():
    assert tpol.available() == jpol.available()
    with pytest.raises(KeyError, match="spectralcache"):
        tpol.resolve(tcache.CachePolicy(kind="spectralcache"))
    with pytest.raises(TypeError):
        tpol.resolve(42)
